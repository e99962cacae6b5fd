"""Registration networks and their checkpoint loader."""

from . import atlas, hyper, modelio, synthmorph, unet, vxm
from .atlas import ConditionalTemplateCreation, MeanStream, ProbAtlasSegmentation, TemplateCreation
from .hyper import HyperVxmDense
from .modelio import load_model, register_config, register_model, save_model
from .synthmorph import (HyperVxmJoint, LabelsToImageConfig, SynthMorphDense,
                         VxmAffineFeatureDetector, labels_to_image)
from .unet import Unet
from .vxm import (InstanceDense, Transform, VxmDense, VxmDenseSemiSupervisedPointCloud,
                  VxmDenseSemiSupervisedSeg)

__all__ = ["ConditionalTemplateCreation", "MeanStream", "ProbAtlasSegmentation",
           "TemplateCreation", "HyperVxmDense", "load_model", "register_config",
           "register_model", "save_model", "HyperVxmJoint", "LabelsToImageConfig",
           "SynthMorphDense", "VxmAffineFeatureDetector", "labels_to_image", "Unet",
           "InstanceDense", "Transform", "VxmDense", "VxmDenseSemiSupervisedPointCloud",
           "VxmDenseSemiSupervisedSeg"]
