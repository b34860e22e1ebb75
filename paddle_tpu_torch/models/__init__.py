"""Model layer of the port: the Llama model, its training step and the
serving forwards."""
from . import convert, generate, llama, train  # noqa: F401
from .convert import params_from_jax, train_state_from_jax  # noqa: F401
from .llama import LlamaConfig, init_params  # noqa: F401
