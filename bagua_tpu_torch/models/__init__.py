from .mlp import MLP  # noqa: F401
from .transformer import TransformerConfig, TransformerLM, lm_loss_fn  # noqa: F401
