"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3 multi-interest
retrieval. [arXiv:1904.08030; unverified].  Item table 2^22 x 64.

``retrieval_cand`` is MIND's native serving mode: 4 interest vectors x 1M
candidates, max-over-interests dot scoring (and the Helmsman IVF path in
examples/train_retrieval.py)."""
from repro_torch.configs import ArchDef, RECSYS_SHAPES
from repro_torch.models.recsys import RecSysConfig

CONFIG = RecSysConfig(
    name="mind", kind="mind", n_sparse=1, embed_dim=64,
    table_rows=1 << 22, seq_len=50, n_interests=4, capsule_iters=3,
)
ARCH = ArchDef("mind", "recsys", CONFIG, dict(RECSYS_SHAPES),
               source="[arXiv:1904.08030; unverified]")
