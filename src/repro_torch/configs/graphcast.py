"""graphcast [gnn] n_layers=16 d_hidden=512 mesh_refinement=6 aggregator=sum
n_vars=227 — encoder-processor-decoder mesh GNN. [arXiv:2212.12794; unverified]

Shapes (assigned):
  full_graph_sm  cora-scale full batch    (N=2708,  E=10556,  d=1433)
  minibatch_lg   reddit-scale sampled     (N=232965, E=114615892, batch=1024,
                                           fanout 15-10, d=602)
  ogb_products   full-batch large         (N=2449029, E=61859140, d=100)
  molecule       batched small graphs     (N=30, E=64, batch=128, d=32)

Edge arrays are padded to a multiple of 512 with an edge mask (edges shard
over the batch axes); the sampled shape's sizes are the padded subgraph of
the 15-10 fanout sampler in data/synthetic.py neighbor_sample.
"""
from repro_torch.configs import ArchDef, ShapeDef
from repro_torch.models.gnn import GNNConfig


def _pad512(e: int) -> int:
    return -(-e // 512) * 512


CONFIG = GNNConfig(name="graphcast", n_layers=16, d_hidden=512,
                   n_vars=227, mesh_refinement=6, aggregator="sum")

SHAPES = {
    "full_graph_sm": ShapeDef(
        "full_graph_sm", "train", batch=1,
        extras=(("n_nodes", 2708), ("n_edges", _pad512(10556)),
                ("d_feat", 1433), ("mode", "full")),
    ),
    "minibatch_lg": ShapeDef(
        "minibatch_lg", "train", batch=1024,
        extras=(("n_nodes", 184320),          # padded sampled frontier
                ("n_edges", 1024 * 15 + 16384 * 10),   # 15360 + 163840
                ("d_feat", 602), ("mode", "sampled")),
    ),
    "ogb_products": ShapeDef(
        "ogb_products", "train", batch=1,
        extras=(("n_nodes", 2449029), ("n_edges", _pad512(61859140)),
                ("d_feat", 100), ("mode", "full")),
    ),
    "molecule": ShapeDef(
        "molecule", "train", batch=128,
        extras=(("n_nodes", 30), ("n_edges", 64), ("d_feat", 32),
                ("mode", "batched")),
    ),
}
ARCH = ArchDef("graphcast", "gnn", CONFIG, SHAPES,
               source="[arXiv:2212.12794; unverified]")
