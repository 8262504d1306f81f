from .cloudprovider import CloudProvider, InstanceType, nodeclass_hash

__all__ = ["CloudProvider", "InstanceType", "nodeclass_hash"]
