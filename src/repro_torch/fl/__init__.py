"""The AFL client/coordinator protocol (port of ``repro.fl``).

The canonical in-process names live in :mod:`repro_torch.fl.api` and the
typed failure taxonomy in :mod:`repro_torch.fl.errors`; both are re-exported
here. The driver loop (:mod:`repro_torch.fl.afl`), the gradient baselines
(:mod:`repro_torch.fl.baselines`) and the partitioners
(:mod:`repro_torch.fl.partition`) stay submodules, as in the reference.
"""

from repro_torch.fl.api import (AFLClient, AFLServer, ClientReport, GammaSweep,
                                SCHEMA_VERSION, VersionedWeights, evaluate_weight,
                                make_report, masked_reports)
from repro_torch.fl.errors import ServiceError

__all__ = [
    "AFLClient",
    "AFLServer",
    "ClientReport",
    "GammaSweep",
    "SCHEMA_VERSION",
    "ServiceError",
    "VersionedWeights",
    "evaluate_weight",
    "make_report",
    "masked_reports",
]
