"""Config module for --arch zamba2-2.7b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["zamba2-2.7b"]
SMOKE = smoke_variant(CONFIG)
