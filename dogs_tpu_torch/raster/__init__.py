from dogs_tpu_torch.raster.binning import TileBins, bins_membership, build_tile_bins
from dogs_tpu_torch.raster.projection import ProjectedGaussians, project_gaussians
from dogs_tpu_torch.raster.reference import render_reference
from dogs_tpu_torch.raster.ssim import dssim_loss, ssim, ssim_map
from dogs_tpu_torch.raster.tiled import RasterConfig, RenderOutput, render_tiled
