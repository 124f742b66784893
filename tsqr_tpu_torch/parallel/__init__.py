"""The distributed layer: SPMD TSQR, BlockQR and CholeskyQR over
``torch.distributed``, one process a rank, each rank holding its own
rows (counterpart of ``tsqr_tpu/parallel``).

  * ``mesh``: :class:`~tsqr_tpu_torch.parallel.mesh.Mesh`,
    ``make_mesh``, ``make_mesh2d``, ``row_shard``, ``vec_shard``;
  * ``comm``: the named collectives and their wire counter;
  * ``dtsqr``: the seven drivers (``dtsqr``, ``dtsqr_hier``, ``dqr``,
    ``dcholqr``, ``dqr_auto``, ``dqr_regen``, ``dsketch``);
  * ``launch``: ``spawn``, a process group with a time limit;
  * ``dryrun``: ``python -m tsqr_tpu_torch.parallel.dryrun WORLD
    [--device cpu]``, on the card unless ``--device cpu``.
"""
