"""Multi-device / multi-host parallel layer (SURVEY.md section 2.7).

* :mod:`.mesh` — device mesh construction + capability report.
* :mod:`.batch` — data-parallel batched extraction, ring matching, and
  block-sharded all-pairs matching.
* :mod:`.spatial` — row-sharded (sequence-parallel analog) pyramid and
  full spatially-sharded extraction with halo exchange.
"""

from .batch import make_allpairs_match_fn, make_batched_extract_fn
from .mesh import make_mesh
from .spatial import make_sharded_extract_fn, make_sharded_pyramid_fn

__all__ = [
    "make_allpairs_match_fn",
    "make_batched_extract_fn",
    "make_mesh",
    "make_sharded_extract_fn",
    "make_sharded_pyramid_fn",
]
