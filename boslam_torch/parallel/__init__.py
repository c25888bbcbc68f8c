"""The multi-device layouts on ``torch.distributed`` (port of
``boslam/parallel``): edge-sharded flat (``sharded``), edge-sharded packed
(``sharded_packed``) and pose-range (``pose_range``) over the process group
of ``mesh``."""

from boslam_torch.parallel.mesh import make_mesh
from boslam_torch.parallel.sharded import pad_edges, sharded_solve

__all__ = ["make_mesh", "pad_edges", "sharded_solve"]
