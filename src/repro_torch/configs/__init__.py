from .catalog import ARCHS, get, smoke_variant

__all__ = ["ARCHS", "get", "smoke_variant"]
