"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
target-attention ranker. [arXiv:1706.06978; paper].  Item table 2^22 x 18."""
from repro_torch.configs import ArchDef, RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="din", kind="din", n_sparse=4, embed_dim=18,
    table_rows=1 << 22, mlp=(200, 80), attn_mlp=(80, 40), seq_len=100,
)
ARCH = ArchDef("din", "recsys", CONFIG, dict(RECSYS_SHAPES),
               source="[arXiv:1706.06978; paper]")
