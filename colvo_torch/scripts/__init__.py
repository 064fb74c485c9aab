"""The README's end-to-end workflows on the port (counterparts of the
repository's ``scripts/``), each run as ``python -m
colvo_torch.scripts.<name>``: ``demo_synthetic`` (train on rendered
sequences, export, evaluate, figures) and ``fullcolon`` (a full-colon
reconstruction from a long rendered sequence)."""
