"""Multi-process ``--sharded`` runs over ``torch.distributed``."""
