"""The port's CLI entrypoint.

Counterpart of `elasticdl_tpu/client/main.py`, with the same verbs:

    python -m elasticdl_tpu_torch.client.main train --model_zoo ... \
        --model_def deepfm.deepfm.custom_model --training_data ... [flags]

`train`, `evaluate` and `predict` run a local job (client/local.py);
`zoo` waits for ROADMAP item 25 and raises.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from elasticdl_tpu_torch.common.config import JobConfig
from elasticdl_tpu_torch.version import __version__

VERBS = ("train", "evaluate", "predict", "zoo", "version")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print(f"usage: python -m elasticdl_tpu_torch.client.main "
              f"{{{'|'.join(VERBS)}}} [flags]")
        return 0
    verb, rest = argv[0], argv[1:]
    if verb == "version":
        print(__version__)
        return 0
    if verb not in VERBS:
        print(f"unknown verb {verb!r}; expected one of {VERBS}", file=sys.stderr)
        return 2
    # deferred import: the launcher pulls in torch; keep `--help` cheap
    from elasticdl_tpu_torch.client import api

    if verb == "zoo":
        return api.zoo(rest)
    cfg = JobConfig.from_argv(rest)
    if verb == "train":
        return api.train(cfg)
    if verb == "evaluate":
        return api.evaluate(cfg)
    return api.predict(cfg)


if __name__ == "__main__":
    raise SystemExit(main())
