"""The AKAZE ladder's work on B images of h x w: the image read once and
the score and both moments of every scale written once; per pixel and
scale, about 25 operations per FED step (gradients, conductance, four
fluxes, update), 13 for the Hessian score, 2 per NMS window side and 8 per
tap of the two separable moments."""


def work(batch: int, h: int, w: int, num_scales: int, diffusion_iterations: int,
         nms_size: int, orientation_patch_size: int) -> tuple[float, float]:
    pixels = batch * h * w
    ops = pixels * num_scales * (25 * diffusion_iterations + 13 + 2 * nms_size
                                 + 8 * orientation_patch_size)
    return ops, 4 * pixels * (1 + 3 * num_scales)
