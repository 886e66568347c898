from .bert import (BertConfig, BertForMaskedLM, BertModel, bert_base_config,
                   bert_tiny_config)
from .convert import (load_numpy_opt_state, load_numpy_state_dict,
                      numpy_state_dict)
from .ernie import (ErnieConfig, ErnieForMaskedLM,
                    ErnieForSequenceClassification, ErnieModel,
                    ernie_tiny_config)
from .llama import (EarlyExitDraft, LlamaConfig, LlamaForCausalLM,
                    LlamaModel, llama_7b_config, llama_tiny_config)
from .unet import (UNet2DConditionModel, UNetConfig, timestep_embedding,
                   unet_sd_config, unet_tiny_config)

__all__ = ["LlamaConfig", "LlamaForCausalLM", "LlamaModel", "EarlyExitDraft",
           "llama_7b_config", "llama_tiny_config",
           "BertConfig", "BertModel", "BertForMaskedLM", "bert_base_config",
           "bert_tiny_config",
           "ErnieConfig", "ErnieModel", "ErnieForMaskedLM",
           "ErnieForSequenceClassification", "ernie_tiny_config",
           "UNetConfig", "UNet2DConditionModel", "unet_tiny_config",
           "unet_sd_config", "timestep_embedding",
           "load_numpy_state_dict", "numpy_state_dict",
           "load_numpy_opt_state"]
