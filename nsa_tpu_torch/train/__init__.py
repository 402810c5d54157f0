"""Training: the byte-corpus data pipeline and the pretraining loop."""
