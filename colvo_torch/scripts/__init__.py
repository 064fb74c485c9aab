"""The README's end-to-end workflows on the port (counterparts of the
repository's ``scripts/``), each run as ``python -m
colvo_torch.scripts.<name>``: ``demo_synthetic`` (train on rendered
sequences, export, evaluate, figures), ``fullcolon`` (a full-colon
reconstruction from a long rendered sequence), ``ablate`` (the DCDP/LCC
ablation grid) and its queues ``gauge_validate``, ``gauge2_requeue`` and
``basin_levers``, the studies of its trained cells ``figures``,
``scale_decoupling`` and ``gauge_probe``, and ``longvideo`` (drift against
length over a long rendered sequence)."""
