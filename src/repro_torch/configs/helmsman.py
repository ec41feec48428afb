"""Helmsman — the paper's own serving config (extra arch beyond the 40 cells).

SIFT100M-scale clustered index: C=2^20 clusters x L=128 slots x D=128 dims
(f32 posting payload = 64 GiB, striped over the 16 `model` shards = 4 GiB
per chip; centroids 512 MiB replicated = the in-DRAM tier; the DRAM:SSD =
1:20 split of §5.1 maps to centroid-bytes : posting-bytes = 1:128/replica~4).

Shapes:
  serve_online  B=4096 queries, nprobe<=256 (search/ads SLA traffic)
  serve_bulk    B=65536 (offline scoring)
  build_step    one distributed k-means Lloyd iteration over 16M vectors
"""
import dataclasses
from repro_torch.configs import ArchDef, ShapeDef


@dataclasses.dataclass(frozen=True)
class HelmsmanConfig:
    name: str = "helmsman"
    n_clusters: int = 1 << 20
    cluster_len: int = 128
    dim: int = 128
    nprobe_max: int = 256
    k: int = 100


CONFIG = HelmsmanConfig()
SHAPES = {
    "serve_online": ShapeDef("serve_online", "anns_serve", batch=4096),
    "serve_bulk": ShapeDef("serve_bulk", "anns_serve", batch=65536),
    "build_step": ShapeDef(
        "build_step", "anns_build", batch=1 << 24,
        extras=(("k_coarse", 4096),),
    ),
}
ARCH = ArchDef("helmsman", "anns", CONFIG, SHAPES,
               source="[this paper; §5.1 setup]")
