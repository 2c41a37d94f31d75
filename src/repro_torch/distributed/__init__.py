"""Distributed training support of the port on ``torch.distributed``: the
sharding rules and their DTensor placements (``sharding``), the GPipe
pipeline (``pipeline``) and fault tolerance with elastic re-meshing
(``fault``)."""
