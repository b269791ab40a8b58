"""Config module for --arch grok-1-314b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["grok-1-314b"]
SMOKE = smoke_variant(CONFIG)
