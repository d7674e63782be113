"""MOFO motion-aware pretraining entry point.

Counterpart of mofo_tpu/cli/pretrain_mofo.py (reference
run_mae_pretraining_BB.py): the runner of cli.pretrain with the
--mask_type tube_bb default (motion-box tube masks and the in-box loss
weight annealed 1 -> 0 over the epochs).

  python -m mofo_tpu_torch.cli.pretrain_mofo \\
      --model pretrain_videomae_small_patch16_224 --synthetic 64 \\
      --batch_size 32 --epochs 2 --warmup_epochs 1 --output_dir out/
"""

from mofo_tpu_torch.cli.pretrain import get_args, main

if __name__ == "__main__":
    main(get_args(mofo_defaults=True))
