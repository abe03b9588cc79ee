"""Hand-written Hopper kernels, one package each (kernel.py binds the CUDA
source in `csrc/`, ops.py dispatches by device, ref.py is the plain PyTorch
version the CPU tests and the parity runs use):

* unipc_update    — fused multi-term solver state update
* adaln_modulate  — fused layernorm + adaLN scale/shift, and the gated
                    residual re-entry
* flash_attention — blockwise online-softmax GQA attention
* quant_matmul    — int8 / int4-in-int8 / fp8 e4m3 weight matmul with
                    fp32 accumulation and per-channel scales (W8A16, W8A8)

Every TPU kernel of `repro/kernels` has its counterpart here.
"""
