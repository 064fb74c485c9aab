"""The VO stream's share of the card's bf16 peak: a frame's model FLOPs
(one depth pass, and one pose pass a pair, two under symmetric pose) times
the window's frames/s."""

from portbench import flops


def read(run):
    fps = run.layer.get("frames_per_s")
    if not fps:
        return None
    cfg = run.layer["cfg"]
    h, w = cfg.data.height, cfg.data.width
    per_frame = (flops.depth_flops(h, w, cfg.model)
                 + (2 if run.layer["symmetric"] else 1) * flops.pose_flops(h, w, cfg.model))
    return 100.0 * per_frame * fps / run.peaks["bf16_flops_s"]
