"""Config module for --arch granite-20b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["granite-20b"]
SMOKE = smoke_variant(CONFIG)
