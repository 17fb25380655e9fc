"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b-smoke \
        --sync-mode compressed_allreduce --wire-format int8 --device cuda

Trains on an emulated data axis of ``--ranks`` ranks on one device (the
card by default; ``--device cpu`` runs the plain PyTorch path). Sync modes:
``grad_allreduce`` (one pass over the global batch), ``param_bcast`` (the
paper's reduce to root + tuned broadcast), ``tuned_allreduce``,
``overlap_allreduce`` and ``compressed_allreduce``.

A MoE model and a vision-prefix model train the same way (a vision
config's batches carry the stub patch embeddings, split over the ranks as
the tokens are):

    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b-smoke \
        --sync-mode tuned_allreduce --device cpu --steps 3 --log-every 1 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch paligemma-3b-smoke \
        --sync-mode tuned_allreduce --device cpu --steps 3 --log-every 1 --seq 32

So do the recurrent (xlstm-350m), hybrid (hymba-1.5b), encoder-decoder
(whisper-large-v3: its batches carry 1500 stub frames a sequence, 16 in
the smoke config, split over the ranks with the tokens) and MHA
(qwen1.5-32b) families, on the CPU at smoke size and on the card at full
width. The whole qwen1.5-32b does not fit one card's 80 GB with its
optimizer state; ``chip_smoke.py`` phase 6f trains it at 3 of its 64
layers through the library (``dataclasses.replace(cfg, num_layers=3)``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-large-v3-smoke \
        --sync-mode param_bcast --device cpu --steps 3 --log-every 1 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \
        --sync-mode tuned_allreduce --device cuda --steps 3 --log-every 1 --seq 512

``tests/test_torch_train_recurrent.py``, ``tests/test_torch_train_hybrid.py``
and ``tests/test_torch_train_encdec_mha.py`` hold these trainings against
the reference's ``Trainer``.

``--model-parallel M`` trains on the reference's local mesh,
``(ranks // M, M)`` over ('data', 'model'): ``grad_allreduce`` in the
reference's FSDP + tensor-parallel layout, for every family but the
recurrent and hybrid ones (xlstm-350m, hymba-1.5b, which it refuses):
the dense decoders, the MoE (its experts or their FFN width cut on
'model'), the vision prefix (heads that do not divide ``M`` replicated)
and the encoder-decoder; the other sync modes stay data-parallel and
refuse it, as the reference's do:

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b-smoke \
        --model-parallel 2 --ranks 8 --device cpu --steps 2 --log-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b-smoke \
        --model-parallel 2 --ranks 8 --device cpu --steps 2 --log-every 1

``tests/test_torch_train_tp.py`` and ``tests/test_torch_train_tp_families.py``
hold it against the reference's model-axis ``Trainer``.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import make_local_mesh, make_mesh
from repro_torch.train.trainer import SYNC_MODES, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgdm", "lion"])
    ap.add_argument("--sync-mode", default="grad_allreduce", choices=list(SYNC_MODES))
    ap.add_argument("--bcast-algo", default="auto")
    ap.add_argument("--allreduce-algo", default="auto")
    ap.add_argument("--wire-format", default="bf16", choices=["bf16", "int8", "fp8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=4, help="emulated ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None, help="packed int32 token .npy file")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    run = RunConfig(
        learning_rate=args.lr,
        warmup_steps=args.warmup,
        total_steps=args.steps,
        optimizer=args.optimizer,
        sync_mode=args.sync_mode,
        bcast_algo=args.bcast_algo,
        allreduce_algo=args.allreduce_algo,
        wire_format=args.wire_format,
        num_microbatches=args.microbatches,
        seed=args.seed,
    )
    mesh = (make_mesh(args.ranks, device=args.device) if args.model_parallel == 1 else
            make_local_mesh(args.model_parallel, n=args.ranks, device=args.device))
    print(f"arch={cfg.name} mesh={dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"device={mesh.device} sync={run.sync_mode} wire={run.wire_format}", flush=True)
    Trainer(cfg, run, mesh=mesh, data_path=args.data, ckpt_dir=args.ckpt_dir,
            device=args.device).train(
        batch=args.batch, seq=args.seq, steps=args.steps, log_every=args.log_every,
        ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
