"""Model definitions (the BASELINE workloads). The port carries ResNet."""

from . import resnet
