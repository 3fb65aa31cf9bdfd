"""Example scripts of the port: the library walkthrough over every
variant (``stream_demo``), the visual artifacts (``make_artifacts``) and
the classical motion-heatmap baseline (``classical_heatmap``). Each runs
as ``python -m cudavideostream_tpu_torch.examples.<name>`` and writes
under ``build/`` unless given ``--out``."""
