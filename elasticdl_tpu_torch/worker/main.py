"""Worker entrypoint.

Counterpart of `elasticdl_tpu/worker/main.py`: parse the re-serialized
argv the master/launcher passed, build the Worker, run the task loop.

    python -m elasticdl_tpu_torch.worker.main --model_def ... [flags]

The worker runs on the card. `EDL_TORCH_DEVICE` names another device
explicitly (`cpu` is what the CPU tests pass through the launcher's
environment); it is a request, never a fallback: with no card and no
request, the worker exits non-zero with the runtime's error before it
registers. A cohort member (`--num_processes > 1`, or `EDL_PROCESS_ID`
set by the process manager) runs `worker/cohort.run_cohort` on card
`cuda:<process id>` (gloo on the CPU when `EDL_TORCH_DEVICE=cpu`).
"""

from __future__ import annotations

import os
import signal
import sys
from typing import List, Optional

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.worker.worker import Worker

DEVICE_ENV = "EDL_TORCH_DEVICE"


def main(argv: Optional[List[str]] = None) -> int:
    cfg = JobConfig.from_argv(sys.argv[1:] if argv is None else argv)
    device = os.environ.get(DEVICE_ENV) or None
    # EDL_PROCESS_ID marks a cohort member even when dynamic resizing has
    # shrunk the world to 1 process (cfg.num_processes is the ORIGINAL size)
    if cfg.num_processes > 1 or "EDL_PROCESS_ID" in os.environ:
        # SPMD cohort member; SIGTERM: the leader drains collectively, a
        # follower exits EX_TEMPFAIL (the wiring is run_cohort's)
        from elasticdl_tpu_torch.worker.cohort import run_cohort

        return run_cohort(cfg, device=device)
    worker = Worker(cfg, device=device)
    # k8s preemption delivers SIGTERM with a grace period; drain + checkpoint
    signal.signal(signal.SIGTERM, lambda *_: worker.preempt())
    return worker.run()


if __name__ == "__main__":
    raise SystemExit(main())
