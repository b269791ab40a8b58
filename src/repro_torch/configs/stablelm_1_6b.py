"""Config module for --arch stablelm-1.6b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["stablelm-1.6b"]
SMOKE = smoke_variant(CONFIG)
