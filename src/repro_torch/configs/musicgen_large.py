"""Config module for --arch musicgen-large (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["musicgen-large"]
SMOKE = smoke_variant(CONFIG)
