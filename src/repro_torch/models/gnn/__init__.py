"""The GNN family (port of ``repro.models.gnn``)."""
from .graphcast import GNNConfig, forward, forward_batched, init_params, make_train_step, mse_loss, param_shapes, param_specs
