"""Evaluation metrics (the port's counterpart of ``stylegan_tpu/metrics``):
Sliced Wasserstein Distance over a Laplacian pyramid (swd.py, no pretrained
features), FID and Inception Score over a torchvision-schema InceptionV3
from a local weights file (fid.py), and Perceptual Path Length with
LPIPS-VGG16 or a pyramid-L2 fallback (ppl.py)."""

from .fid import (compute_fid, compute_inception_score, fid_from_features,
                  frechet_distance, inception_score_from_probs,
                  inception_v3_init, load_inception_weights, make_feature_fn,
                  make_probs_fn)
from .ppl import (load_lpips_weights, lpips_vgg_init, make_lpips_fn,
                  make_pyramid_distance, ppl_samples, ppl_score)
from .swd import sliced_wasserstein_distance

__all__ = ["sliced_wasserstein_distance", "compute_fid", "fid_from_features",
           "frechet_distance", "inception_v3_init", "load_inception_weights",
           "make_feature_fn", "compute_inception_score",
           "inception_score_from_probs", "make_probs_fn",
           "load_lpips_weights", "lpips_vgg_init", "make_lpips_fn",
           "make_pyramid_distance", "ppl_samples", "ppl_score"]
