"""Residual (Bi)LSTM networks (follows deepxi_tpu/models/rnn.py): `ResLSTM`
(reslstm-1.0c) and `ResBiLSTM`.

Each block is one LSTM over the whole sequence whose output is added to its
input. The cell is flax's `nn.OptimizedLSTMCell`: per-gate input kernels
`cell.i{i,f,g,o}.kernel` [C, h] (no bias) and recurrent kernels and biases
`cell.h{i,f,g,o}.{kernel,bias}` [h, h] and [h], gates i, f, o sigmoid and
g tanh, c' = f c + i g, h' = o tanh(c'), the carry (c, h) starting at zero.
A step whose frame is masked (no input feature nonzero, Keras
``Masking(0.0)``: an all-zero frame inside an utterance too) keeps the
state and repeats the previous output, so neither `torch.nn.LSTM` nor
cuDNN's packed sequences compute it. The input products of all steps are
hoisted into one product a block, written time-major: where autograd records
nothing (inference, export) the op `deepxi::lstm_input_proj`, one kernel on
the card, and under autograd (training) autograd's `addmm`. The recurrence is
`masked_lstm` (`ops/kernels/lstm.py`): the op `deepxi::masked_lstm` where
autograd records nothing, and under autograd its Function, whose forward and
backward are kernels too (on the card the CUDA kernels, on the CPU their
plain versions).
"""

from __future__ import annotations

import torch
from torch import nn

from deepxi_tpu_torch.models.attention import Dense, LayerNorm, sequence_valid_mask
from deepxi_tpu_torch.models.tcn import output_activation
from deepxi_tpu_torch.ops.kernels import records_grad
from deepxi_tpu_torch.ops.kernels.lstm import input_product, lstm_input_proj, masked_lstm

GATES = "ifgo"


class LSTMCell(nn.Module):
    """flax `nn.OptimizedLSTMCell`'s parameters: `i{gate}` input kernels
    [C_in, h] and `h{gate}` recurrent kernels [h, h] with biases, gate order
    i, f, g, o (held as `Dense` parameters; `MaskedLSTM` computes the cell)."""

    def __init__(self, c_in: int, h: int):
        super().__init__()
        for g in GATES:
            self.add_module(f"i{g}", Dense(c_in, h, use_bias=False))
            self.add_module(f"h{g}", Dense(h, h))

    def stacked(self):
        """([W_i, W_f, W_g, W_o] the input kernels [C, h], W_h [h, 4h], b
        [4h]): the recurrent kernels and biases concatenated in i|f|g|o
        order."""
        hh = [getattr(self, f"h{g}") for g in GATES]
        return ([getattr(self, f"i{g}").kernel for g in GATES],
                torch.cat([m.kernel for m in hh], 1), torch.cat([m.bias for m in hh]))


class MaskedLSTM(nn.Module):
    """An LSTM over [B, T, C] with per-step masking (`reverse`: from the
    last padded frame to the first); returns [B, T, h]."""

    def __init__(self, c_in: int, h: int, reverse: bool = False):
        super().__init__()
        self.reverse = reverse
        self.cell = LSTMCell(c_in, h)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        w_x, w_h, b = self.cell.stacked()
        # the input products of every step at once, time-major: autograd's
        # addmm in training, else the op (one kernel on the card)
        if records_grad(x, *w_x, b):
            xp = input_product(x, w_x, b)
        else:
            xp = lstm_input_proj(x, w_x, b)
        ys = masked_lstm(xp, w_h, mask.transpose(0, 1), self.reverse)
        return ys.transpose(0, 1)


class ResLSTM(nn.Module):
    """Residual LSTM: bias-free dense in-projection -> LayerNorm -> ReLU,
    then `n_blocks` residual LSTM blocks (with `bidirectional`, a forward and
    a reverse LSTM summed), then the output dense layer and activation.
    reslstm-1.0c (d_model 512, 5 blocks) has 10,760,449 parameters in 65
    leaves."""

    bidirectional = False

    def __init__(self, n_feat: int, n_outp: int, n_blocks: int = 5,
                 d_model: int = 512, outp_act: str = "Sigmoid"):
        super().__init__()
        self.n_blocks, self.outp_act = n_blocks, outp_act
        self.ff_dense = Dense(n_feat, d_model, use_bias=False)
        self.ff_ln = LayerNorm(d_model)
        for i in range(n_blocks):
            if self.bidirectional:
                self.add_module(f"block{i}_lstm_fwd", MaskedLSTM(d_model, d_model))
                self.add_module(f"block{i}_lstm_bwd", MaskedLSTM(d_model, d_model, True))
            else:
                self.add_module(f"block{i}_lstm", MaskedLSTM(d_model, d_model))
        self.out_dense = Dense(d_model, n_outp)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        mask = sequence_valid_mask(inp)
        x = torch.relu(self.ff_ln(self.ff_dense(inp)))
        for i in range(self.n_blocks):
            if self.bidirectional:
                h = (getattr(self, f"block{i}_lstm_fwd")(x, mask)
                     + getattr(self, f"block{i}_lstm_bwd")(x, mask))
            else:
                h = getattr(self, f"block{i}_lstm")(x, mask)
            x = x + h
        return output_activation(self.out_dense(x), self.outp_act)


class ResBiLSTM(ResLSTM):
    """Residual bidirectional LSTM: each block sums a forward and a reverse
    LSTM over the whole padded sequence."""

    bidirectional = True


def init_recurrent_kernels_(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Each LSTM cell's recurrent kernels orthogonal, as flax initialises
    `OptimizedLSTMCell`, from `generator` (a CPU generator, on CPU tensors);
    its input kernels (lecun_normal) and biases (zero) are `Dense`
    parameters, which `attention.init_flax_like` draws."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, LSTMCell):
                for g in GATES:
                    nn.init.orthogonal_(getattr(m, f"h{g}").kernel, generator=generator)
    return net
