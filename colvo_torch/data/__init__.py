"""Host data code (numpy only): synthetic colon renderer, snippets,
augmentation and intrinsics; the device prefetcher; and the
device-resident corpus with its on-device augmentation."""

from colvo_torch.data.augment import augment_snippet, color_jitter
from colvo_torch.data.device_store import DeviceSnippetStore, device_augment
from colvo_torch.data.intrinsics import Intrinsics, scale_intrinsics
from colvo_torch.data.prefetch import prefetch_to_device
from colvo_torch.data.snippets import Snippet, SnippetDataset, batch_iterator, synthetic_dataset
from colvo_torch.data.synthetic import (
    ColonSequence,
    colon_texture,
    make_trajectory,
    render_frame,
    render_sequence,
)

__all__ = [
    "Intrinsics",
    "scale_intrinsics",
    "Snippet",
    "SnippetDataset",
    "synthetic_dataset",
    "batch_iterator",
    "prefetch_to_device",
    "DeviceSnippetStore",
    "device_augment",
    "augment_snippet",
    "color_jitter",
    "ColonSequence",
    "render_frame",
    "render_sequence",
    "make_trajectory",
    "colon_texture",
]
