from .export import ExportCfg
from .gravity import GravityFieldData

__all__ = ["ExportCfg", "GravityFieldData"]
