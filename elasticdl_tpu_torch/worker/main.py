"""Worker entrypoint.

Counterpart of `elasticdl_tpu/worker/main.py`: parse the re-serialized
argv the master/launcher passed, build the Worker, run the task loop.

    python -m elasticdl_tpu_torch.worker.main --model_def ... [flags]

The worker runs on the card. `EDL_TORCH_DEVICE` names another device
explicitly (`cpu` is what the CPU tests pass through the launcher's
environment); it is a request, never a fallback: with no card and no
request, the worker exits non-zero with the runtime's error before it
registers.
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
    # EDL_PROCESS_ID marks a cohort member even when dynamic resizing has
    # shrunk the world to 1 process (cfg.num_processes is the ORIGINAL size)
    if cfg.num_processes > 1 or "EDL_PROCESS_ID" in os.environ:
        raise NotImplementedError(
            "the SPMD cohort (num_processes > 1, EDL_PROCESS_ID) is ROADMAP "
            "item 18")
    worker = Worker(cfg, device=os.environ.get(DEVICE_ENV) or None)
    # k8s preemption delivers SIGTERM with a grace period; drain + checkpoint
    signal.signal(signal.SIGTERM, lambda *_: worker.preempt())
    return worker.run()


if __name__ == "__main__":
    raise SystemExit(main())
