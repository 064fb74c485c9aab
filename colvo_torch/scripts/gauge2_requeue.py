"""The gauge validation queue again, the collapsed seed-runs first (port
of ``scripts/gauge2_requeue.py``).

The same cells as ``gauge_validate`` under the same defaults (the gauge
prior on at its band [0.03, 0.3]) in the order of evidence: the three
seed-runs that collapsed in the reference's round 4 first (they alone
decide the pass: polyp e_mean ≤ 0.3, no collapse), then the other seeds of
those two cells, the flagship, the restart protocol's proof at seed 1234
(``train.restart_*``), and the ``lcc_identity`` and ``photo_native`` cells;
into ``runs/gauge2``.

Run: ``python -m colvo_torch.scripts.gauge2_requeue [steps] [out_root]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import sys

from colvo_torch.scripts import ablate
from colvo_torch.scripts.gauge_validate import gauge_cells


def main(steps: int = 4000, out_root: str = "runs/gauge2", device: str = "cuda") -> None:
    ablate.run_queue(gauge_cells(requeue=True), steps, out_root, device)


if __name__ == "__main__":
    args = ablate.parser("colvo_torch.scripts.gauge2_requeue", "runs/gauge2",
                         __doc__).parse_args(sys.argv[1:])
    main(args.steps, args.out_root, args.device)
