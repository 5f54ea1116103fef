from .imputer import InfImputer

__all__ = ["InfImputer"]
