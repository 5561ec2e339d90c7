"""Data-parallel and multi-process training (port of umpr_tpu/parallel).

``multihost`` joins processes into one ``torch.distributed`` world and
carries the primary-only writes, barriers and broadcasts; ``mesh`` lays
the ranks out as ``--mesh_shape`` and splits each global batch into row
blocks.  A run that forms no process group (the default) calls no
collective.
"""
