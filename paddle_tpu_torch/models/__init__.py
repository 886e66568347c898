from .convert import (load_numpy_opt_state, load_numpy_state_dict,
                      numpy_state_dict)
from .llama import (EarlyExitDraft, LlamaConfig, LlamaForCausalLM,
                    LlamaModel, llama_7b_config, llama_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "EarlyExitDraft",
           "llama_7b_config", "llama_tiny_config",
           "load_numpy_state_dict", "numpy_state_dict",
           "load_numpy_opt_state"]
