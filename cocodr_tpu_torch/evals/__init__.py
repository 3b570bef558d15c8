"""Retrieval metrics and the MS MARCO MRR evaluation (the BEIR pipeline
is pipelines/eval_beir.py)."""
