"""tpudas_torch.detect — streaming detection over the live stream.

The port's counterpart of :mod:`tpudas.detect`.  The realtime drivers
are open to registered
:class:`~tpudas_torch.detect.operators.StreamOperator` instances that
consume the decimated output stream with the same O(1)-carry discipline
the filters use: ``init_state`` / ``process(rows, t_ns, step_ns,
carry) -> (results, carry)``, chunk-invariant by contract, so a retried
round and a process restart replay byte-identically.

- :mod:`tpudas_torch.detect.operators` — the contract + registry and
  the two operators (recursive STA/LTA events, rolling-RMS anomaly
  scores), plain torch ops on the operator's device;
- :mod:`tpudas_torch.detect.ledger` — the durable artifacts: a
  crc-stamped events ledger (JSONL + ``.prev``) and per-channel score
  tiles;
- :mod:`tpudas_torch.detect.runner` — the per-round hook the realtime
  drivers call (``detect=True`` / ``TPUDAS_DETECT=1``): emitted-patch
  fast path, file-backed catch-up, and the scores → ledger → carry
  commit protocol.

Every file has the JAX package's format: a carry, ledger or score
store either package wrote resumes under the other.  The JAX package's
``GET /events`` endpoint and its startup audit of these files are not
ported yet.
"""

from tpudas_torch.detect.ledger import (
    DETECT_DIRNAME,
    ScoreStore,
    load_events,
)
from tpudas_torch.detect.operators import (
    DetectResult,
    RollingRmsOperator,
    StaLtaOperator,
    StreamOperator,
    make_operator,
    operator_names,
    register_operator,
)
from tpudas_torch.detect.runner import (
    DEFAULT_OPERATORS,
    DetectPipeline,
    run_detect_round,
)

__all__ = [
    "DEFAULT_OPERATORS",
    "DETECT_DIRNAME",
    "DetectPipeline",
    "DetectResult",
    "RollingRmsOperator",
    "ScoreStore",
    "StaLtaOperator",
    "StreamOperator",
    "load_events",
    "make_operator",
    "operator_names",
    "register_operator",
    "run_detect_round",
]
