"""Config module for --arch h2o-danube-3-4b (see catalog.py for the citation)."""
from .catalog import ARCHS, smoke_variant

CONFIG = ARCHS["h2o-danube-3-4b"]
SMOKE = smoke_variant(CONFIG)
