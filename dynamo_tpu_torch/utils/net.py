"""Failure classification for bounded failover.

The port's own copy of `dynamo_tpu/utils/net.py` (it imports nothing
of the JAX package); keep the two in step.

Retrying a request is only safe when the failure PROVES the request never
reached the peer — a refused connection, an unroutable host, a DNS miss.
Anything that can occur after the request bytes were written (reset,
broken pipe, EOF mid-response) means the peer may already be working on
it, and a retry would duplicate that work: a duplicated prefill parks KV
nobody ever pulls; a duplicated generation double-bills the client. Both
the frontend's worker failover and the disagg decode client's prefill
failover route through here so the policy can't drift between them.
"""

from __future__ import annotations

import errno
import socket

# errnos that can only be raised while ESTABLISHING the connection
_PRE_SEND_ERRNOS = frozenset({
    errno.ECONNREFUSED,
    errno.EHOSTUNREACH,
    errno.ENETUNREACH,
    errno.ENETDOWN,
    errno.EHOSTDOWN,
    errno.EADDRNOTAVAIL,
})


def pre_send_failure(exc: BaseException) -> bool:
    """True when `exc` (or a URLError's wrapped reason) proves the request
    was never delivered, making a retry on another peer safe."""
    reason = getattr(exc, "reason", exc)  # URLError wraps the socket error
    if isinstance(reason, (TimeoutError, socket.timeout)):
        return False  # peer accepted and may be mid-request
    if isinstance(reason, ConnectionRefusedError):
        return True
    if isinstance(reason, socket.gaierror):
        return True  # DNS failure: no connection was ever attempted
    if isinstance(reason, ConnectionError):
        # reset / aborted / broken pipe: the connect succeeded, so the
        # request may have been received — NOT retry-safe
        return False
    if isinstance(reason, OSError):
        return reason.errno in _PRE_SEND_ERRNOS
    return False
