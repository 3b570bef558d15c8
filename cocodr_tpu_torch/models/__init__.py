"""BERT encoder and dual-encoder retrieval models in PyTorch."""
