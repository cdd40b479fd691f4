"""repro_torch.distributed — how a campaign's lanes split over devices."""
