"""CLI: convert a reference .pth state_dict into a checkpoint of the port,
the counterpart of vs_seg_tpu/compat/convert_checkpoint.py (same argv):

  python -m vs_seg_tpu_torch.compat.convert_checkpoint best_metric_model.pth \
      best_metric_model.ckpt [--no_attention]

The output is the port's checkpoint, {"model": state_dict, "epoch": -1,
"best_metric": -1.0, "best_metric_epoch": -1} written by torch.save, which
cli/inference.py reads as kind "torch" (train/checkpoint.py:load_model_state;
it also accepts the raw .pth, this tool just materialises the converted
form).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("src", help="reference .pth state_dict")
    parser.add_argument("dst", help="output .ckpt path")
    parser.add_argument("--no_attention", dest="attention", action="store_false")
    parser.set_defaults(attention=True)
    args = parser.parse_args(argv)

    from vs_seg_tpu_torch.compat.from_jax import jax_state_dict
    from vs_seg_tpu_torch.compat.torch_import import (import_unet2d5_spvpa,
                                                      load_pth)
    from vs_seg_tpu_torch.train.checkpoint import save_checkpoint

    params, stats = import_unet2d5_spvpa(load_pth(args.src),
                                         attention=args.attention)
    save_checkpoint(args.dst, {
        "model": jax_state_dict({"params": params, "batch_stats": stats}),
        "epoch": -1, "best_metric": -1.0, "best_metric_epoch": -1,
    })
    print(f"converted {args.src} -> {args.dst}")


if __name__ == "__main__":
    main()
