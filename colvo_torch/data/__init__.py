"""Host data code (numpy only): synthetic colon renderer, snippets,
augmentation and intrinsics."""

from colvo_torch.data.augment import augment_snippet, color_jitter
from colvo_torch.data.intrinsics import Intrinsics, scale_intrinsics
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
    "augment_snippet",
    "color_jitter",
    "ColonSequence",
    "render_frame",
    "render_sequence",
    "make_trajectory",
    "colon_texture",
]
