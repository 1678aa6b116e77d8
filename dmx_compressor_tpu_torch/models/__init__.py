"""Model zoo of the port: OPT, GPT-2, Llama, Qwen3, Gemma, Mistral, T5,
Whisper, CLIP and LeNet-5, authored with transformable modules in
HF-checkpoint layouts."""

from ..ops.kv_cache import KVCache, QuantizedKVCache  # noqa: F401
from .clip import CLIPConfig, CLIPModel  # noqa: F401
from .gemma import GemmaConfig, GemmaForCausalLM  # noqa: F401
from .gpt2 import GPT2Config, GPT2LMHeadModel  # noqa: F401
from .lenet import LeNet5  # noqa: F401
from .llama import LlamaConfig, LlamaForCausalLM  # noqa: F401
from .mistral import MistralConfig, MistralForCausalLM  # noqa: F401
from .opt import OPTConfig, OPTForCausalLM, loss_fn  # noqa: F401
from .qwen3 import Qwen3Config, Qwen3ForCausalLM  # noqa: F401
from .t5 import T5Config, T5ForConditionalGeneration  # noqa: F401
from .whisper import WhisperConfig, WhisperForConditionalGeneration  # noqa: F401
