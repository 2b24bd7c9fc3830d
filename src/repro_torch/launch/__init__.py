"""Launch layer: the training and serving entry points (``launch.train``,
``launch.serve``), and the dry-run's meshes, cells and cost records
(``launch.mesh``, ``launch.cell``, ``launch.dryrun``)."""
