"""Validate the depth<->pose gauge prior by training again (port of
``scripts/gauge_validate.py``).

The reference's round-4 ablation found translation-gauge collapse (polyp
error 5-10, s_traj/s_depth 100-200× off) in three seed-runs:
``expjit_dcdp1_lccG`` at seeds 7 and 1234 and ``dcdp0_lcc0`` at 1234. With
``loss.gauge_*`` on by default, this trains those two cells at the three
seeds, the flagship ``dcdp1_lcc1`` (which must not regress), the automask
identity calibrated under global LCC (``loss.lcc_identity``) and
``loss.photo_native``, each at three seeds, through ``ablate.run_cell``:
the ablation's protocol and held-out evaluation, into ``runs/gauge``.
Pass: no collapse (polyp e_mean ≤ 0.3 a seed) in the two cells, the
flagship within its earlier spread.

:func:`gauge_cells` builds this queue and ``gauge2_requeue``'s from
``ablate.SEEDS``.

Run: ``python -m colvo_torch.scripts.gauge_validate [steps] [out_root]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import sys
from typing import List

from colvo_torch.scripts import ablate
from colvo_torch.scripts.ablate import SEEDS

# the restart protocol's proof cell: detect the weak basin at step 1500, re-init up to twice
RESTART = {"train.restart_threshold": 0.015, "train.restart_check_step": 1500,
           "train.restart_max": 2}


def gauge_cells(requeue: bool = False) -> List[dict]:
    """The gauge queue's cells, each group at every seed of ``SEEDS``.

    ``requeue=False`` (``gauge_validate``): the flagship first (its weights
    feed the full-colon run), then ``expjit_dcdp1_lccG``, ``dcdp0_lcc0``,
    ``expjit_dcdp1_lccG_ident`` and ``dcdp1_lcc1_pnative``.

    ``requeue=True`` (``gauge2_requeue``): the three collapsed seed-runs
    first, which alone decide the pass, then the other seeds of those two
    cells, the flagship, the restart cell at seed 1234, the identity and
    ``photo_native`` cells.
    """
    lccg = dict(dcdp=True, lcc=True, exp_jitter=0.35, lcc_mode="global+affine",
                name="expjit_dcdp1_lccG")
    flagship = [dict(dcdp=True, lcc=True, seed=s) for s in SEEDS]
    jittered = [dict(lccg, seed=s) for s in SEEDS]
    plain = [dict(dcdp=False, lcc=False, seed=s) for s in SEEDS]
    ident = [dict(lccg, seed=s, name="expjit_dcdp1_lccG_ident",
                  overrides={"loss.lcc_identity": True}) for s in SEEDS]
    pnative = [dict(dcdp=True, lcc=True, seed=s, name="dcdp1_lcc1_pnative",
                    overrides={"loss.photo_native": True}) for s in SEEDS]
    if not requeue:
        return flagship + jittered + plain + ident + pnative
    collapsed = [jittered[1], jittered[2], plain[2]]
    rest = [jittered[0], plain[0], plain[1]]
    restart = dict(dcdp=True, lcc=True, seed=SEEDS[2], name="dcdp1_lcc1_restart",
                   overrides=dict(RESTART))
    return collapsed + rest + flagship + [restart] + ident + pnative


def main(steps: int = 4000, out_root: str = "runs/gauge", device: str = "cuda") -> None:
    ablate.run_queue(gauge_cells(), steps, out_root, device)


if __name__ == "__main__":
    args = ablate.parser("colvo_torch.scripts.gauge_validate", "runs/gauge",
                         __doc__).parse_args(sys.argv[1:])
    main(args.steps, args.out_root, args.device)
