"""The canonical AFL serving error taxonomy.

Every way a federation request can fail is one of the typed errors below —
raised in-process by the coordinators and the service, and carried over the
wire as a stable ``code`` string plus message, so a remote caller re-raises
the *same* exception type it would have seen in-process (wire-equivalence
extends to the failure paths, not just the happy ones).

Design rules:

  * Errors that an in-process coordinator historically raised as
    ``ValueError`` (duplicate client, γ mismatch, corrupt report, solving an
    empty federation) stay ``ValueError`` subclasses, so pre-service call
    sites and tests keep working unchanged.
  * ``code`` is the wire-stable identity (never rename), ``http_status`` is
    what the HTTP transport maps it to, and ``retryable`` marks the errors a
    well-behaved client may back off and retry (today: backpressure).
"""

from __future__ import annotations

from typing import Dict, Type

__all__ = [
    "ServiceError",
    "BadRequest",
    "CorruptReport",
    "OversizedReport",
    "DuplicateClient",
    "GammaMismatch",
    "EmptyFederation",
    "Backpressure",
    "ReadOnlyFederation",
    "Unauthorized",
    "Unavailable",
    "UnknownFederation",
    "ERROR_CODES",
    "from_code",
]


class ServiceError(Exception):
    """Base of the taxonomy: a wire-stable ``code``, an HTTP status, and a
    retryability flag. Never raised bare — always one of the subclasses."""

    code: str = "internal"
    http_status: int = 500
    retryable: bool = False


class BadRequest(ServiceError, ValueError):
    """Malformed request at the protocol level: unknown route, unparseable
    request envelope, missing required fields."""

    code = "bad_request"
    http_status = 400


class CorruptReport(ServiceError, ValueError):
    """A :class:`~repro_torch.fl.api.ClientReport` payload that failed parsing or
    validation (bad magic, CRC mismatch, truncated arrays, non-finite
    statistics, unknown schema version, wrong dimensions)."""

    code = "corrupt_report"
    http_status = 400


class OversizedReport(ServiceError, ValueError):
    """A report payload larger than the service's ``max_report_bytes`` —
    rejected before parsing, so a hostile upload cannot balloon memory."""

    code = "oversized_report"
    http_status = 413


class DuplicateClient(ServiceError, ValueError):
    """A client id that already contributed to this federation (the AA law
    aggregates each client exactly once)."""

    code = "duplicate_client"
    http_status = 409


class GammaMismatch(ServiceError, ValueError):
    """A report whose local regularizer γ differs from the federation's —
    the RI restore is only exact when every client used the same γ."""

    code = "gamma_mismatch"
    http_status = 409


class EmptyFederation(ServiceError, ValueError):
    """A solve/sweep/weights request before any client has reported."""

    code = "empty_federation"
    http_status = 409


class Backpressure(ServiceError):
    """The async ingest queue is at its high-watermark — or a mesh resize
    (grow/shrink) is migrating shards — and the submission was NOT
    aggregated. Retryable — back off and resubmit."""

    code = "backpressure"
    http_status = 429
    retryable = True


class ReadOnlyFederation(ServiceError, ValueError):
    """A mutating request (submit / grow / shrink) sent to a weights read
    replica. Replicas follow the primary's ledger and never ingest — send
    writes to the primary endpoint. Not retryable *here*: retrying against
    the replica can never succeed."""

    code = "read_only"
    http_status = 403


class Unauthorized(ServiceError):
    """The federation requires a bearer token and the request carried a
    missing or wrong one. Checked before routing, so nothing was applied and
    coordinator state is untouched. Not retryable: resending the same
    credentials can never succeed — obtain a valid token first."""

    code = "unauthorized"
    http_status = 401


class Unavailable(ServiceError):
    """The federation exists but is temporarily not being served — its
    coordinator died and a failover restore is in flight. Nothing was
    applied. Retryable — back off until the replacement coordinator is
    installed (``FederationService.restore_federation``)."""

    code = "unavailable"
    http_status = 503
    retryable = True


class UnknownFederation(ServiceError, KeyError):
    """A federation id the service does not host."""

    code = "unknown_federation"
    http_status = 404


ERROR_CODES: Dict[str, Type[ServiceError]] = {
    cls.code: cls
    for cls in (BadRequest, CorruptReport, OversizedReport, DuplicateClient,
                GammaMismatch, EmptyFederation, Backpressure,
                ReadOnlyFederation, Unauthorized, Unavailable,
                UnknownFederation)
}


def from_code(code: str, message: str) -> ServiceError:
    """Rebuild the typed error a wire response carried (client side). An
    unknown code (newer server) degrades to the ``ServiceError`` base."""
    cls = ERROR_CODES.get(code)
    if cls is None:
        err = ServiceError(f"[{code}] {message}")
        return err
    return cls(message)
