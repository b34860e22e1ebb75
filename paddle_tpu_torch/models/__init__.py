"""Model layer of the port: the Llama, GPT-2 and ERNIE models, their
shared training step, dense generation and the serving forwards.
``generate`` stays the module (as in the JAX package); dense decoding is
``generate.generate``."""
from . import convert, ernie, generate, gpt, llama, moe, train  # noqa: F401
from .convert import params_from_jax, train_state_from_jax  # noqa: F401
from .ernie import ErnieConfig  # noqa: F401
from .generate import (beam_search, precompute_prompt_cache,  # noqa: F401
                       quantize_weights)
from .llama import LlamaConfig, init_params  # noqa: F401
from .moe import MoEConfig  # noqa: F401
