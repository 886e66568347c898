from .convert import (load_numpy_opt_state, load_numpy_state_dict,
                      numpy_state_dict)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,
                    llama_7b_config, llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama_7b_config", "llama_tiny_config",
           "load_numpy_state_dict", "numpy_state_dict",
           "load_numpy_opt_state"]
