"""The AFL client/coordinator protocol (port of ``repro.fl``).

The canonical in-process names live in :mod:`repro_torch.fl.api`; the
serving layer — :class:`FederationService`, the in-proc/HTTP transports and
the wire-true :class:`RemoteCoordinator` — in :mod:`repro_torch.fl.service`,
the multiplexed transport in :mod:`repro_torch.fl.mux`, the report ledger
and its followers in :mod:`repro_torch.fl.replication`, and the typed
failure taxonomy in :mod:`repro_torch.fl.errors`. All are re-exported here.
The driver loop (:mod:`repro_torch.fl.afl`), the gradient baselines
(:mod:`repro_torch.fl.baselines`) and the partitioners
(:mod:`repro_torch.fl.partition`) stay submodules, as in the reference.
"""

from repro_torch.fl.api import (AFLClient, AFLServer, ClientReport, Coordinator,
                                GammaSweep, SCHEMA_VERSION,
                                ShardedCoordinator, Transport,
                                VersionedWeights, evaluate_weight, make_report,
                                masked_reports)
from repro_torch.fl.async_server import AsyncAFLServer, SubmitAborted
from repro_torch.fl.errors import ServiceError
from repro_torch.fl.mux import (MuxFederationServer, MuxTransport,
                                client_ssl_context, generate_self_signed_cert,
                                mux_ping, probe_alive, serve_mux,
                                server_ssl_context)
from repro_torch.fl.replication import (LedgerTailer, ReportLedger, WarmStandby,
                                        WeightsReplica, compact_ledger_dir,
                                        watch_primary)
from repro_torch.fl.service import (FederationService, HttpTransport,
                                    InProcTransport, RemoteCoordinator,
                                    promote_remote, serve_http)

__all__ = [
    "AFLClient",
    "AFLServer",
    "AsyncAFLServer",
    "ClientReport",
    "Coordinator",
    "FederationService",
    "GammaSweep",
    "HttpTransport",
    "InProcTransport",
    "LedgerTailer",
    "MuxFederationServer",
    "MuxTransport",
    "RemoteCoordinator",
    "ReportLedger",
    "SCHEMA_VERSION",
    "ServiceError",
    "ShardedCoordinator",
    "SubmitAborted",
    "Transport",
    "VersionedWeights",
    "WarmStandby",
    "WeightsReplica",
    "client_ssl_context",
    "compact_ledger_dir",
    "evaluate_weight",
    "generate_self_signed_cert",
    "make_report",
    "masked_reports",
    "mux_ping",
    "probe_alive",
    "promote_remote",
    "serve_http",
    "serve_mux",
    "server_ssl_context",
    "watch_primary",
]
