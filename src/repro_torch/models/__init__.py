from . import config, layers, attention, model  # noqa: F401
from .config import ModelConfig  # noqa: F401
