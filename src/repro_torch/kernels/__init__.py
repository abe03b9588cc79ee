"""Hand-written Hopper kernels, one package each (kernel.py binds the CUDA
source in `csrc/`, ops.py dispatches by device, ref.py is the plain PyTorch
version the CPU tests and the parity runs use):

* unipc_update    — fused multi-term solver state update
* adaln_modulate  — fused layernorm + adaLN scale/shift, and the gated
                    residual re-entry
* flash_attention — blockwise online-softmax GQA attention, and MLA's
                    form (192-deep scores over 128-wide values)
* quant_matmul    — int8 / int4-in-int8 / fp8 e4m3 weight matmul with
                    fp32 accumulation and per-channel scales (W8A16, W8A8)

Every TPU kernel of `repro/kernels` has its counterpart here. Besides,
`grouped_mm` dispatches a dropless MoE's grouped expert products: torch's
own `_grouped_mm` on the card (no kernel of the port's), a loop of
products off it.
"""
