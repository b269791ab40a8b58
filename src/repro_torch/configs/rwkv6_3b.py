"""Config module for --arch rwkv6-3b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["rwkv6-3b"]
SMOKE = smoke_variant(CONFIG)
