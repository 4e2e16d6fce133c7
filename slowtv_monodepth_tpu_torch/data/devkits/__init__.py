from ...paths import DATA_PATHS as PATHS

__all__ = ['PATHS']
