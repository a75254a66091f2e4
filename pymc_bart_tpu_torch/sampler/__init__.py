from . import hmc, nuts, pgbart
from .compound import PGBART, CompiledModel, sample

__all__ = ["PGBART", "CompiledModel", "hmc", "nuts", "pgbart", "sample"]
