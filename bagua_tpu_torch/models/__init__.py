from .mlp import MLP  # noqa: F401
from .transformer import TransformerConfig, TransformerLM, lm_loss_fn  # noqa: F401
from .generate import decode_model, generate, generate_tp  # noqa: F401
from .vgg import VGG, VGG16, VGG19, vgg_loss_fn  # noqa: F401
