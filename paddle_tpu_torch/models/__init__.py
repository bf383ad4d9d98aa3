from . import convert, gpt  # noqa: F401
from .gpt import GPTForCausalLM  # noqa: F401
