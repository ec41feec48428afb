"""wide-deep [recsys] n_sparse=40 embed_dim=32 mlp=1024-512-256.
[arXiv:1606.07792; paper].  Table: 2^24 rows, row-sharded."""
from repro_torch.configs import ArchDef, RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="wide-deep", kind="wide_deep", n_sparse=40, embed_dim=32,
    table_rows=1 << 24, mlp=(1024, 512, 256),
)
ARCH = ArchDef("wide_deep", "recsys", CONFIG, dict(RECSYS_SHAPES),
               source="[arXiv:1606.07792; paper]")
