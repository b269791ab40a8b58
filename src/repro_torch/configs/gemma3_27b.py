"""Config module for --arch gemma3-27b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["gemma3-27b"]
SMOKE = smoke_variant(CONFIG)
