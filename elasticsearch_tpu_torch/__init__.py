"""PyTorch + CUDA port of elasticsearch_tpu for one NVIDIA H100.

Same results as the JAX package (hits, order, fp32 score bits, totals); its
device kernels are hand-written CUDA (csrc/, ops/kernels.py). Entry points
run on the CUDA device by default: `node.Node`, `rest.server.RestServer`,
`index.tiles.pack_segment`.
"""
