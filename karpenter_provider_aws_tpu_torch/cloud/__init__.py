from .fake import CloudInstance, FakeCloud, LaunchOverride

__all__ = ["FakeCloud", "CloudInstance", "LaunchOverride"]
