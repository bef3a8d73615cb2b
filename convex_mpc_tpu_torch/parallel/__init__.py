"""Scale-out of the scenario batch over processes, one device each (torch.distributed)."""
