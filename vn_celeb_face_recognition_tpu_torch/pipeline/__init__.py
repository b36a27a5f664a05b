"""Recognition pipelines: the fused chunk engine and alignment templates.
(The per-face ``recognition`` module is not ported yet.)"""
