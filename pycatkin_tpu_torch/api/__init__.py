"""The user-facing facade (:class:`System`), its preset workflows and
plots."""
from .system import System
