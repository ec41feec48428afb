"""xdeepfm [recsys] n_sparse=39 embed_dim=10 cin=200-200-200 mlp=400-400.
[arXiv:1803.05170; paper].  Table: 2^24 rows (criteo-scale), row-sharded."""
from repro_torch.configs import ArchDef, RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="xdeepfm", kind="xdeepfm", n_sparse=39, embed_dim=10,
    table_rows=1 << 24, mlp=(400, 400), cin_layers=(200, 200, 200),
)
ARCH = ArchDef("xdeepfm", "recsys", CONFIG, dict(RECSYS_SHAPES),
               source="[arXiv:1803.05170; paper]")
