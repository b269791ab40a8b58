"""Config module for --arch mixtral-8x7b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["mixtral-8x7b"]
SMOKE = smoke_variant(CONFIG)
