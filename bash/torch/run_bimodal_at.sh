#!/bin/sh
# AT (audio-text) fine-tuning on AudioCaps, trimodal CVALP with siamese
# module sharing, on one NVIDIA GPU with the PyTorch/CUDA package:
# bash/run_bimodal_at.sh pointed at `python -m vipant_tpu_torch`.
#
#   bash bash/torch/run_bimodal_at.sh trimodal [override ...]
#
# `mesh.data=-1` is the data axis over every rank: with NPROC > 1 the script
# runs `torchrun --nproc_per_node=$NPROC`, one process a card, and the loss
# sees the global batch. The large-batch variant adds
# `running.grad_cache.alive=True running.grad_cache.chunk_size=128` (the
# gradient cache; the trimodal monitor refuses it, as it has three streams:
# use it with LAMonitor). `model_file` takes a
# reference `.pth` (2- or 4-tuple), a step directory of the port's trainer,
# or a training log for repeated eval; `async_ckpt=True` writes the
# checkpoints in the background; `platform=cpu` runs on the CPU.

run_type=${1:-trimodal}
[ $# -ge 1 ] && shift  # remaining args pass through as config overrides

data_root=${DATA_ROOT:-/data/audiocaps}
model_file=${MODEL_FILE:-}      # VA-pre-trained checkpoint
model_name=${MODEL_NAME:-test}
batch_size=${BATCH_SIZE:-64}
num_proc=${NUM_PROC:-8}

mtask="
model_name=$model_name monitor=VALMonitor worker=CVALP num_proc=$num_proc eval=False verbose=True
+model/image=vit_val +model/audio=vit_val +model/text=transformer_val +model/loss=ce_val
+optimizer=standard +running/audio=default
model.audio.pre_encoder.in_channels=3 model.audio.pre_encoder.stride=[16,24]
optimizer.warmup=False running.audio.norms=[-4.93839311,5.75751113]
running.siamese.alive=True running.imagine=False model.loss.va=False
running.batch_size=$batch_size running.peep_rate=1 running.prompt=
model_file=$model_file
running.rnd_cap=True
running.data_root=$data_root
running.data_name=audiocaps_train running.eval_name=audiocaps_val
running.test_name=audiocaps_test
running.eval_samples=250 running.test_samples=250 running.train_samples=0.1
mesh.data=-1
"

nproc=${NPROC:-1}
if [ "$nproc" -gt 1 ]; then
  torchrun --nproc_per_node="$nproc" -m vipant_tpu_torch +running=$run_type $mtask "$@"
else
  python -m vipant_tpu_torch +running=$run_type $mtask "$@"
fi
