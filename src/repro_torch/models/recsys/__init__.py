from .embedding import embedding_bag, embedding_bag_sharded, embedding_lookup, embedding_lookup_sharded
from .models import RecSysConfig, bce_loss, forward, init_params, make_train_step, param_shapes, param_specs, retrieval_scores
