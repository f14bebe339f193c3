"""Hand-written Hopper kernels (csrc/*.cu, built at first use by _build.py)
and their plain PyTorch twins:

  conv333.py  conv333        <- vs_seg_tpu/ops/pallas_conv333.py:conv333
              (kd in {1, 3})
  rublock.py  ru_block       <- vs_seg_tpu/ops/pallas_rublock.py:ru_block
  l2block.py  l2_block       <- vs_seg_tpu/ops/pallas_l2block.py:l2_block
              (+ attgate, csrc/attgate.cu)
  block2d.py  ru_block2d, l2_block2d
                             <- vs_seg_tpu/ops/experimental/pallas_block2d.py:
                                ru_block2d (csrc/rublock2d.cu), l2_block2d
                                (csrc/l2block2d.cu; past C, Cout = 16
                                conv333 at kd = 1 + attgate)
  tail2d.py   tail_block     <- vs_seg_tpu/ops/experimental/pallas_tail2d.py:
                                tail_block (csrc/tail2d.cu; past its widths
                                attgate + conv333 at kd = 1)
  att.py      fused_attention_gate
                             <- vs_seg_tpu/ops/experimental/pallas_att.py:
                                fused_attention_gate (csrc/attgate.cu)
  dsconv.py   ds_conv        <- vs_seg_tpu/ops/experimental/pallas_dsconv.py:
                                ds_conv (csrc/conv333.cu at stride 2)
  blend.py    blend_scatter  <- vs_seg_tpu/ops/pallas_blend.py:
                                pallas_blend_scatter
  conv333_dw.py  conv333_dw  <- vs_seg_tpu/ops/experimental/pallas_train.py:
                                conv333_dw (+ dw_extract/db_extract)
  train_conv.py  Conv333Train, conv333_train
                             <- vs_seg_tpu/ops/experimental/pallas_train.py:
                                conv333_train (dx via conv333, dw/db via
                                conv333_dw)
  ring_probe.py  ring_probe  <- tools/ring_probe.py:_kernel (the Mosaic ring
                                probe; csrc/ring.cuh's first user)
  bnorm_train.py bn_dropout_prelu
                             <- no Pallas kernel (XLA fuses the chain in
                                JAX): a train-mode Convolution's BatchNorm
                                -> dropout -> PReLU, a statistics pass and
                                an apply pass each way (csrc/bnorm_train.cu)

Importing these modules builds nothing.
"""
