"""Dataset curation: describe → cluster → quota-constrained MMR selection."""

from .core import Curator, Item  # noqa: F401
