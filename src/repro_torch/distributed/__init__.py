"""Distributed training support of the port: the single-process part of
fault tolerance (``fault``).  Sharding and pipelining wait for ROADMAP Queue 1
item 17."""
