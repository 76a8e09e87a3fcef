"""The benchmark of plutracer_tpu_torch: its harness (spec, traffic, trace,
work, check, main) and its frozen plain reference (reference/)."""
