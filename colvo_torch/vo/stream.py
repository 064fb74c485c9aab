"""Chunked streaming VO (port of ``colvo/vo/stream.py``): the serving path.

A colonoscopy video streams through in chunks of ``chunk_size`` frames:

* frames cross host→device as uint8 RGB, or as planar I420 straight from a
  video decoder (1.5 bytes a pixel), and are decoded (BT.601) and
  normalised on the device;
* each frame's depth encoder runs once: the previous chunk's last
  normalised frame and its depth bottleneck are carried on the device into
  the next chunk, which forms the pairs (carry→f0, f0→f1, …);
* a chunk's depths (float32, float16, or uint8 disparity quantised per
  frame) and its float32 poses go back in one wire buffer, bit-cast into
  bytes on the device, so a chunk makes one device→host copy; poses are
  never rounded;
* the first frame's step and the chunk step are each one program
  (``runtime.graphs``), as the reference jits ``init_fn`` and ``chunk_fn``:
  on a CUDA device a CUDA graph a (chunk shape, input format, wire dtype,
  symmetric pose), kept on the runner and replayed once a chunk; the last
  chunk is padded, so a stream replays one graph;
* on a CUDA device, a chunk's host→device copy runs from pinned memory on
  a copy stream, the wire's device→host copy lands in pinned memory behind
  a recorded event, and fetch threads decode it; at most ``max_in_flight``
  chunks are in flight, so a stream of any length takes O(chunk) memory
  on the device and the host.

Pose chaining stays on the host in float64 (``vo/driver.py``).

A stream is the span ``vo.run`` (``runtime.spans``). Each chunk in it is
``vo.chunk`` (attr ``chunk``, its index), which holds on the calling
thread ``vo.drain`` (blocked on the decoded results of the oldest chunk,
whose index it carries), on the card ``vo.slot_wait`` (the wait for the
chunk's pinned slot), ``vo.stage`` (the frames stacked into it; on the CPU
into a new array), on the card ``vo.h2d`` (the copy queued), the chunk
program's ``graph.*`` spans and ``vo.d2h`` (the wire's copy queued; on the
CPU its clone). On a fetch thread a chunk is ``vo.fetch_wait`` (on the
card, the wait for the wire's copy) and ``vo.decode``.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from colvo_torch.geometry import disp_to_depth
from colvo_torch.runtime.infer import InferenceRunner
from colvo_torch.runtime.spans import span

WIRE_DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32, "float16": torch.float16, "uint8": torch.uint8}
INPUT_FORMATS = ("rgb", "i420", "i420full")


def rgb_to_i420(frames: np.ndarray, video_range: bool = True) -> np.ndarray:
    """Pack uint8 RGB frames (N, H, W, 3) into planar I420 (N, H·3/2, W).

    ``video_range=True`` (default): limited-range (studio-swing) BT.601,
    Y∈[16,235], the convention of H.26x/VP9 decoders, which
    ``input_format="i420"`` decodes. ``video_range=False``: full range (the
    JPEG convention), for ``input_format="i420full"``. H must be a multiple
    of 4 and W even, so that the U and V planes start on row boundaries of
    the (H·3/2, W) view. A host helper for tests and benchmarks: real
    sources take I420 straight from the video decoder.
    """
    n, h, w, _ = frames.shape
    if h % 4 or w % 2:
        raise ValueError(
            f"I420 (H*3/2, W) packing needs H % 4 == 0 and W % 2 == 0, got {(h, w)}"
        )
    f = frames.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b
    v = 0.5 * r - 0.418688 * g - 0.081312 * b
    if video_range:
        y = 16.0 + y * (219.0 / 255.0)
        u = u * (224.0 / 255.0)
        v = v * (224.0 / 255.0)
    u, v = u + 128.0, v + 128.0
    # 2×2 chroma average then subsample (the standard 4:2:0 down-filter)
    u = u.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    v = v.reshape(n, h // 2, 2, w // 2, 2).mean(axis=(2, 4))
    out = np.empty((n, h * 3 // 2, w), np.uint8)
    out[:, :h] = np.clip(y + 0.5, 0, 255).astype(np.uint8)
    out[:, h:h + h // 4] = np.clip(u + 0.5, 0, 255).astype(np.uint8).reshape(n, h // 4, w)
    out[:, h + h // 4:] = np.clip(v + 0.5, 0, 255).astype(np.uint8).reshape(n, h // 4, w)
    return out


def i420_to_rgb(x: torch.Tensor, video_range: bool = True) -> torch.Tensor:
    """Planar I420 (B, H·3/2, W) uint8 → RGB (B, 3, H, W) float32 in [0, 1].

    BT.601, limited range (``video_range=True``) or full range, with
    nearest 2× chroma upsampling.
    """
    b, h32, w = x.shape
    h = h32 * 2 // 3
    y = x[:, :h].float()
    u = x[:, h:h + h // 4].reshape(b, h // 2, w // 2).float() - 128.0
    v = x[:, h + h // 4:].reshape(b, h // 2, w // 2).float() - 128.0
    if video_range:
        y = (y - 16.0) * (255.0 / 219.0)
        u = u * (255.0 / 224.0)
        v = v * (255.0 / 224.0)
    u = u.repeat_interleave(2, 1).repeat_interleave(2, 2)
    v = v.repeat_interleave(2, 1).repeat_interleave(2, 2)
    rgb = torch.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], dim=1)
    return rgb.clamp(0.0, 255.0) / 255.0


def normalize(frames: torch.Tensor, input_format: str = "rgb") -> torch.Tensor:
    """Frames as they crossed (B, H, W, 3) RGB, uint8 or float in [0, 1], or
    (B, H·3/2, W) I420 → the model's input, (B, 3, H, W) float32 in [0, 1]."""
    if input_format != "rgb":
        return i420_to_rgb(frames, video_range=input_format == "i420")
    imgs = frames.permute(0, 3, 1, 2).float()
    if frames.dtype == torch.uint8:
        imgs = imgs / 255.0
    return imgs.contiguous()


def _sdisp(runner: InferenceRunner, disps) -> torch.Tensor:
    """Scaled disparity (B, H, W) of the finest scale; depth = 1/sdisp."""
    m = runner.cfg.model
    return disp_to_depth(disps[0][:, 0], m.min_depth, m.max_depth)[0]


def _init_body(runner: InferenceRunner, frame: torch.Tensor, input_format: str):
    """The first frame (1, …) on the device → (float32 depth (1, H, W),
    carry image, carry bottleneck)."""
    img = normalize(frame, input_format)
    disps, bneck = runner.model.depth(img)
    return 1.0 / _sdisp(runner, disps), img, bneck


def _chunk_body(runner: InferenceRunner, carry_img: torch.Tensor, carry_bneck: torch.Tensor,
                frames: torch.Tensor, input_format: str, wire_dtype: torch.dtype,
                symmetric_pose: bool):
    """W new frames on the device → (uint8 wire, next carry image, next
    carry bottleneck). Pairs are (carry→f0, f0→f1, …)."""
    model, w = runner.model, frames.shape[0]
    imgs = normalize(frames, input_format)
    # Compute dtype: frames enter the model as float32 and each conv
    # casts to its compute dtype (bf16 on the card), so the carried
    # float32 image concatenates with this chunk's float32 frames.
    disps, bnecks = model.depth(imgs)
    img_a = torch.cat([carry_img, imgs[:-1]])
    bneck_a = torch.cat([carry_bneck, bnecks[:-1]])
    fuse = runner.cfg.model.dcdp_fusion
    if symmetric_pose:
        # Forward and reversed readings as one batch of 2W pairs
        # (GroupNorm is per sample, so batching changes nothing).
        feats = [torch.cat([bneck_a, bnecks]), torch.cat([bnecks, bneck_a])]
        aa, tr = model.pose(torch.cat([img_a, imgs]), torch.cat([imgs, img_a]),
                            feats if fuse else None)
        aa, tr = 0.5 * (aa[:w] - aa[w:]), tr[:w]
    else:
        aa, tr = model.pose(img_a, imgs, [bneck_a, bnecks] if fuse else None)
    pose6 = torch.cat([aa, tr], dim=-1).float()
    # The carry: clones, so that it shares memory with nothing the next
    # chunk writes.
    return (_pack(_sdisp(runner, disps), pose6, wire_dtype), imgs[-1:].clone(),
            bnecks[-1:].clone())


def _pack(sdisp: torch.Tensor, pose6: torch.Tensor, wire_dtype: torch.dtype) -> torch.Tensor:
    """Depths and poses → one flat uint8 buffer, by bit-casts."""
    if wire_dtype == torch.uint8:
        # per-frame linear quantisation in disparity space; (lo, step)
        # ride along as float32
        lo = sdisp.amin(dim=(1, 2))
        span = sdisp.amax(dim=(1, 2)) - lo
        step = torch.clamp(span / 255.0, min=1e-12)
        # Clip before the cast: rounding can push the top bin a hair
        # past 255, and an unclipped uint8 cast would wrap it to 0.
        q = torch.round((sdisp - lo[:, None, None]) / step[:, None, None])
        parts = [q.clamp(0, 255).to(torch.uint8), torch.stack([lo, step], dim=-1), pose6]
    else:
        parts = [(1.0 / sdisp).to(wire_dtype), pose6]
    return torch.cat([p.reshape(-1).view(torch.uint8) for p in parts])


class StreamingVO:
    """Chunked streaming depth + pose over an :class:`InferenceRunner`, on
    the runner's device.

    ``depth_dtype`` is the wire dtype of the depth maps: ``"float16"``
    (default, ~5e-4 relative error), ``"float32"`` (exact), or ``"uint8"``
    (disparity quantised per frame, error ≤ half a step of 1/255 of the
    frame's disparity span). Depths come back as float32 in every mode,
    poses as the exact float32 the model gave.

    ``symmetric_pose=True`` reads every pair both ways and averages the
    rotation only: ``aa = 0.5·(aa_fwd − aa_rev)`` with the forward
    translation (the net's forward-motion prior gives a forward-signed
    translation in both readings, so averaging it would cancel the motion).
    """

    def __init__(
        self,
        runner: InferenceRunner,
        chunk_size: int = 16,
        depth_dtype: str = "float16",
        fetch_workers: int = 4,
        input_format: str = "rgb",
        symmetric_pose: bool = False,
    ):
        if input_format not in INPUT_FORMATS:
            raise ValueError(f"input_format {input_format!r} not in {INPUT_FORMATS}")
        if depth_dtype not in WIRE_DTYPES:
            raise ValueError(f"depth_dtype {depth_dtype!r} not in {tuple(WIRE_DTYPES)}")
        self.runner = runner
        self.device = runner.device
        self.chunk_size = int(chunk_size)
        self.fetch_workers = int(fetch_workers)
        self.input_format = input_format
        self.wire_dtype = WIRE_DTYPES[depth_dtype]
        self.symmetric_pose = bool(symmetric_pose)
        # Bounded in-flight work: chunks issued but not yet decoded. Each
        # holds one pinned staging buffer, one device wire and one pinned
        # wire buffer, reused round-robin.
        self.max_in_flight = max(8, 2 * self.fetch_workers)

    # --- the device steps ------------------------------------------------

    def _static(self) -> dict:
        return {"input_format": self.input_format, "wire_dtype": self.wire_dtype,
                "symmetric_pose": self.symmetric_pose}

    def init_step(self, frame: torch.Tensor):
        """The first frame (1, …) → (float32 depth (1, H, W), carry image,
        carry bottleneck): one replay of the runner's ``_init_body`` program
        (``runtime.graphs``); the next init step overwrites them."""
        return self.runner.program(_init_body)(frame, input_format=self.input_format)

    def chunk_step(self, carry_img: torch.Tensor, carry_bneck: torch.Tensor,
                   frames: torch.Tensor):
        """W new frames → (uint8 wire, next carry image, next carry
        bottleneck): one replay of the runner's ``_chunk_body`` program, one
        graph per (chunk shape, input format, wire dtype, symmetric pose).
        The outputs are the program's static outputs, which the next chunk
        step overwrites; the carry goes straight back in."""
        return self.runner.program(_chunk_body)(carry_img, carry_bneck, frames,
                                                **self._static())

    def chunk_body(self, carry_img: torch.Tensor, carry_bneck: torch.Tensor,
                   frames: torch.Tensor):
        """``chunk_step``'s body, run eagerly."""
        return _chunk_body(self.runner, carry_img, carry_bneck, frames, **self._static())

    # --- the host side ---------------------------------------------------

    def decode_wire(self, wire: np.ndarray, hw: Tuple[int, int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """A fetched wire buffer → (float32 depths (W, H, W'), pose6 (W, 6)),
        both fresh arrays that share no memory with ``wire``."""
        w, n_px = self.chunk_size, self.chunk_size * hw[0] * hw[1]
        if self.wire_dtype == torch.uint8:
            q = wire[:n_px].reshape(w, *hw)
            meta = wire[n_px:n_px + 8 * w].view(np.float32).reshape(w, 2)
            depths = 1.0 / (meta[:, 0, None, None] + q.astype(np.float32) * meta[:, 1, None, None])
            n_d = n_px + 8 * w
        else:
            n_d = n_px * self.wire_dtype.itemsize
            np_dtype = np.float16 if self.wire_dtype == torch.float16 else np.float32
            depths = wire[:n_d].view(np_dtype).reshape(w, *hw).astype(np.float32)
        return depths, wire[n_d:].view(np.float32).reshape(w, 6).copy()

    def _chunks(self, it: Iterator[np.ndarray]) -> Iterator[Tuple[List[np.ndarray], int]]:
        """The remaining frames in blocks of ``chunk_size`` and their count
        of real frames; the last block is padded by repeating its last frame,
        so that every chunk has one shape."""
        w, buf = self.chunk_size, []
        for f in it:
            buf.append(f)
            if len(buf) == w:
                yield buf, w
                buf = []
        if buf:
            n = len(buf)
            yield buf + [buf[-1]] * (w - n), n

    @torch.inference_mode()
    def run(
        self, frames: Iterable[np.ndarray], keep_depths: bool = True,
        keyframe_every: Optional[int] = None,
    ) -> Tuple[List[np.ndarray], np.ndarray]:
        """Stream frames → (per-frame float32 depth maps, (N-1, 6) relative
        poses (axisangle, translation), float32).

        ``keep_depths=False`` drops every depth map after its fetch (an
        empty list comes back), so a long run keeps O(chunk) on the host;
        the wire carries depth all the same. ``keyframe_every=k`` keeps only
        the depth maps of frames whose index is a multiple of k (frame 0
        always), and implies ``keep_depths``.
        """
        ke = int(keyframe_every) if keyframe_every else 1
        if keyframe_every:
            keep_depths = True
        it = iter(frames)
        try:
            first = np.asarray(next(it))
        except StopIteration:
            return [], np.zeros((0, 6), np.float32)
        if self.input_format == "rgb":
            hw = first.shape[:2]
        else:  # planar (H·3/2, W) in; depths at the RGB size
            hw = (first.shape[0] * 2 // 3, first.shape[1])

        with span("vo.run"):
            d0, carry_img, carry_bneck = self.init_step(
                torch.from_numpy(first[None]).to(self.device))
            depths, poses = self._stream(it, hw, carry_img, carry_bneck, keep_depths, ke)
            all_depths = [d0[0].to("cpu", copy=True).numpy()] + depths if keep_depths else []
        rel = np.concatenate(poses) if poses else np.zeros((0, 6), np.float32)
        return all_depths, rel

    def _stream(self, it: Iterator[np.ndarray], hw: Tuple[int, int], carry_img: torch.Tensor,
                carry_bneck: torch.Tensor, keep_depths: bool, ke: int
                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """The frames after the first, chunk by chunk → (the kept depth
        maps, the (n, 6) poses of each chunk)."""
        pipe = _CudaPipe(self.device, self.max_in_flight) if self.device.type == "cuda" else None
        depths: List[np.ndarray] = []
        poses: List[np.ndarray] = []
        next_idx = 1  # frame index of the first frame of the next drained chunk

        def fetch(buf, event, n, k):
            if event is not None:
                # Do not decode a pinned buffer before its copy has landed.
                with span("vo.fetch_wait", chunk=k):
                    event.synchronize()
            with span("vo.decode", chunk=k):
                return (*self.decode_wire(buf.numpy(), hw), n)

        def drain(k, fut):
            nonlocal next_idx
            with span("vo.drain", chunk=k):
                dn, pn, n = fut.result()
            if keep_depths:
                depths.extend(dn[i] for i in range(n) if (next_idx + i) % ke == 0)
            next_idx += n
            poses.append(pn[:n])

        pending: deque = deque()
        with ThreadPoolExecutor(max_workers=self.fetch_workers) as pool:
            for k, (chunk, n_valid) in enumerate(self._chunks(it)):
                with span("vo.chunk", chunk=k):
                    # Bounded in-flight work, and the slot of chunk k (that
                    # of chunk k - max_in_flight) free; drained in order, so
                    # the results stay in order whatever order the fetches
                    # end in.
                    while len(pending) >= self.max_in_flight:
                        drain(*pending.popleft())
                    if pipe:
                        dev = pipe.upload(k, chunk)
                    else:
                        with span("vo.stage", chunk=k):
                            dev = torch.from_numpy(np.stack(chunk))
                    wire, carry_img, carry_bneck = self.chunk_step(carry_img, carry_bneck, dev)
                    # The wire is the program's static output, which the
                    # next chunk overwrites: on the card its copy to the
                    # host is queued before that replay; on the CPU a fetch
                    # thread decodes it meanwhile, so it takes a copy.
                    if pipe:
                        buf, event = pipe.download(k, wire)
                    else:
                        with span("vo.d2h", chunk=k):
                            buf, event = wire.clone(), None
                    pending.append((k, pool.submit(fetch, buf, event, n_valid, k)))
            while pending:
                drain(*pending.popleft())
        return depths, poses


class _CudaPipe:
    """Pinned staging for the host→device copies of chunks (on a copy
    stream) and for the device→host copies of wires (on the compute
    stream, each followed by an event), ``slots`` of each, reused
    round-robin by chunk index."""

    def __init__(self, device: torch.device, slots: int):
        self.device, self.slots = device, slots
        self.compute = torch.cuda.current_stream(device)
        self.copy = torch.cuda.Stream(device)
        self.h2d: List[Optional[torch.Tensor]] = [None] * slots
        self.h2d_done = [torch.cuda.Event() for _ in range(slots)]
        self.d2h: List[Optional[torch.Tensor]] = [None] * slots

    def upload(self, k: int, chunk: List[np.ndarray]) -> torch.Tensor:
        s = k % self.slots
        staging = self.h2d[s]
        if staging is None:
            staging = torch.from_numpy(np.empty((len(chunk), *chunk[0].shape), chunk[0].dtype))
            staging = self.h2d[s] = staging.pin_memory()
        # Reused pinned buffers: do not overwrite this buffer while its last
        # host→device copy may still be queued.
        with span("vo.slot_wait", chunk=k):
            self.h2d_done[s].synchronize()
        with span("vo.stage", chunk=k):
            np.stack(chunk, out=staging.numpy())
        with span("vo.h2d", chunk=k):
            with torch.cuda.stream(self.copy):
                dev = staging.to(self.device, non_blocking=True)
                self.h2d_done[s].record()
            self.compute.wait_stream(self.copy)
            # ``dev`` was allocated on the copy stream and is read on the
            # compute stream (copied there into the chunk program's static
            # input): keep the allocator from reusing it early.
            dev.record_stream(self.compute)
        return dev

    def download(self, k: int, wire: torch.Tensor) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Queue the wire's copy into slot k's pinned buffer; the caller
        has drained the chunk that used this slot before."""
        s = k % self.slots
        if self.d2h[s] is None:
            self.d2h[s] = torch.empty(wire.shape, dtype=wire.dtype, pin_memory=True)
        with span("vo.d2h", chunk=k):
            self.d2h[s].copy_(wire, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.compute)
        return self.d2h[s], event
