"""Config module for --arch qwen2-vl-7b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["qwen2-vl-7b"]
SMOKE = smoke_variant(CONFIG)
