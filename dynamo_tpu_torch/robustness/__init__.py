"""The worker's failure-domain hardening: the port's own copies of
`dynamo_tpu/robustness/` (it imports nothing of the JAX package).

- `faults`   — the deterministic fault-injection plane: named fault points
  in the serving path and the engine, armed through the environment or
  `/internal/faults`, seeded so chaos drills replay identically.
- `deadline` — end-to-end deadline propagation: the client's budget rides
  an `x-deadline` header; an exhausted budget sheds with 504.
- `watchdog` — the engine watchdog: hung device seams trip it, the health
  state machine sheds, resurrects in place or quarantines, and integrity
  sentinels abort exactly the poisoned streams.

The JAX package's `breaker` (the frontend's circuit breakers) belongs to
the frontend tier, which is not ported yet.
"""
