"""Launch surfaces of the port: ``python -m repro_torch.launch.serve``,
``.train`` (``--mesh``), ``.trace`` and the dry run ``.dryrun``; the meshes
(``mesh``) and the grid's cells and step functions (``cells``)."""
