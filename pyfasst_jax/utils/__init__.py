"""Math / misc utilities (reference parity: pyfasst/tools/utils.py, UNVERIFIED)."""

from pyfasst_jax.utils.misc import nextpow2, db, ident
from pyfasst_jax.utils.config import GEMConfig, AnnealingMode

__all__ = ["nextpow2", "db", "ident", "GEMConfig", "AnnealingMode"]
