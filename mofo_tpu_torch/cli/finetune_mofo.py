"""MOFO BB-focused finetuning entry point.

Counterpart of mofo_tpu/cli/finetune_mofo.py (reference
run_class_finetuning_BB.py): the runner of cli.finetune with the
vit_base_patch16_224_BB_focused default (the backbone's tokens fused inside
and outside the motion box, --fusing_mode MCA by default).

  python -m mofo_tpu_torch.cli.finetune_mofo --synthetic 40 \\
      --batch_size 10 --epochs 2 --warmup_epochs 1 \\
      --finetune pretrain.pth --output_dir ft/
"""

from mofo_tpu_torch.cli.finetune import get_args, main

if __name__ == "__main__":
    main(get_args(bb_defaults=True))
