"""Configurations and data shared by tests/test_torch_unsup_train.py and
tests/test_torch_unsup_cli.py: the two GAN cases, tiny model and
frontend sizes, and the synthetic corpus they train on, for the JAX
package and the port alike."""

import itertools
import pathlib

import numpy as np

from uasr.config import Config as JaxConfig
from uasr.config import CTCConfig as JaxCTCConfig
from uasr.config import DataConfig as JaxDataConfig
from uasr.config import EODMConfig as JaxEODMConfig
from uasr.config import FrontendConfig as JaxFrontendConfig
from uasr.config import GANConfig as JaxGANConfig
from uasr.config import ModelConfig as JaxModelConfig
from uasr.config import TrainConfig as JaxTrainConfig
from uasr_torch import config as tc
from uasr_torch.data.dataset import batch_iterator, make_synthetic_dataset

REPO = pathlib.Path(__file__).resolve().parents[1]
B = 8  # JAX's run_gan_training shards the batch over the suite's 8 CPU devices
MODEL = dict(encoder="classifier", classifier_hidden=24, classifier_layers=2,
             classifier_context=1, disc_channels=16, disc_layers=2, disc_kernel=5)
FRONT = dict(num_mel_bins=16, downsample=3)
CASES = {
    # bce + joint EODM over the merged stream, every output regulariser,
    # label smoothing, critic weight decay and the scheduled GAN rates
    "bce_eodm": (dict(objective="bce", disc_steps=2, g_lr=3e-3, d_lr=5e-3,
                      d_weight_decay=1e-2, merge_repeats=True, diversity_weight=0.5,
                      smoothness_weight=3.0, entropy_weight=0.2, real_label_smooth=0.1,
                      use_lr_schedule=True),
                 dict(ngram_orders=(1, 2), top_k=20, k_chunk=8), True),
    # WGAN-GP with the semi-supervised CTC mix-in on a labeled stream
    "wgan_ctc": (dict(objective="wgan-gp", disc_steps=2, g_lr=1e-3, d_lr=4e-3,
                      supervised_weight=0.5), dict(), False),
}
TRAIN = dict(lr=2e-3, lr_schedule="warmup_exp_decay", warmup_steps=2, decay_rate=0.5,
             decay_steps=2, total_steps=3, log_every=1, eval_every=1000, save_every=1000, seed=0)


def corpus(n=32, seed=0):
    examples, vocab = make_synthetic_dataset(num_utts=n, num_phones=6, seed=seed,
                                             syntax="markov", min_len=3, max_len=6)
    return examples, vocab


def batches(examples, n, seed=0):
    it = batch_iterator(examples, B, 16000, 8, seed=seed)
    return [tuple(np.asarray(x) for x in b) for b in itertools.islice(it, n)]


def cfgs(case, model_dir, vocab_size):
    gan, eodm, _ = CASES[case]
    jc = JaxConfig(model_dir=str(model_dir), frontend=JaxFrontendConfig(**FRONT),
                   model=JaxModelConfig(**MODEL), ctc=JaxCTCConfig(),
                   gan=JaxGANConfig(**gan), eodm=JaxEODMConfig(**eodm),
                   data=JaxDataConfig(batch_size=B, max_label_len=8),
                   train=JaxTrainConfig(mode="gan+eodm", **TRAIN), vocab_size=vocab_size)
    pc = tc.Config(model_dir=str(model_dir), frontend=tc.FrontendConfig(**FRONT),
                   model=tc.ModelConfig(**MODEL), ctc=tc.CTCConfig(use_pallas=True),
                   gan=tc.GANConfig(**gan), eodm=tc.EODMConfig(**eodm),
                   data=tc.DataConfig(batch_size=B, max_label_len=8),
                   train=tc.TrainConfig(mode="gan+eodm", **TRAIN), vocab_size=vocab_size)
    return jc, pc
