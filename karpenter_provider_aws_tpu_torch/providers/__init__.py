from .subnet import SubnetProvider
from .securitygroup import SecurityGroupProvider
from .instanceprofile import InstanceProfileProvider
from .amifamily import AMI_FAMILIES, AMIProvider, resolve_ami_family, storage_config
from .launchtemplate import LaunchTemplateProvider
from .pricing import PricingProvider
from .version import VersionProvider

__all__ = ["SubnetProvider", "SecurityGroupProvider", "InstanceProfileProvider",
           "AMIProvider", "AMI_FAMILIES", "resolve_ami_family",
           "LaunchTemplateProvider", "PricingProvider", "VersionProvider"]
