"""The launcher: a per-device account of every (arch x shape) cell on the
production meshes (``dryrun``), built from the cells' programs
(``steps``), the meshes (``mesh``) and the accounting functions of
``analysis/accounting.py``. Run it as
``python -m repro_torch.launch.dryrun``."""
