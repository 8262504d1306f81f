"""Cloud providers. Only the AMI family table is ported (the fake cloud's
network builds its images from it); the subnet, security-group,
instance-profile, launch-template, pricing and version providers wait
for the Operator."""

from .amifamily import AMI_FAMILIES, AMIProvider, resolve_ami_family, storage_config

__all__ = ["AMI_FAMILIES", "AMIProvider", "resolve_ami_family",
           "storage_config"]
