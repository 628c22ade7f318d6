"""Data-parallel training over the ranks of a `torch.distributed` process
group: joining it (`distributed.py`) and the collectives of the step
(`mesh.py`)."""
