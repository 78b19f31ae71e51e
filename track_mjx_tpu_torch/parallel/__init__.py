"""Data parallelism across devices: one process per device over
torch.distributed (`mesh.py`)."""
