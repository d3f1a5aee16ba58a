"""Device code — the equivalents of the reference's SPIR-V stages.

Each module names the shader / fixed-function stage it re-implements:

* ``background`` — gradient_color.comp / sky.comp compute passes
* ``vertex`` — mesh.vert (batched MVP transform + attribute setup)
* ``raster`` — the hardware rasterizer inside vkCmdDrawIndexed
  (coverage, reversed-Z depth test) as a per-tile bin walk: a Pallas
  kernel through Triton on the GPU, with a plain XLA form beside it
* ``shade`` — mesh.frag (deferred: lighting + texture sampling)
* ``present`` — swapchain blit (rgba16f -> unorm8)
"""
