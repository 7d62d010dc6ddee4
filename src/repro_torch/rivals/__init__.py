"""Rival federated samplers (counterpart of ``repro.rivals``): the
facade's method table and the FA-LD oracle. FA-LD itself runs in the
engine as ``aggregation='fald'``; the ELF compression legs live in
``repro_torch.fed.compress`` (``direction=``)."""
from repro_torch.rivals.fald import fald_run_vmap
from repro_torch.rivals.methods import METHODS, Method, get_method

__all__ = ["METHODS", "Method", "get_method", "fald_run_vmap"]
