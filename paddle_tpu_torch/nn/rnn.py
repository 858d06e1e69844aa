"""Recurrent layers of the port (``paddle_tpu/nn/rnn.py`` counterpart).

The cells follow JAX's (and Paddle's, and torch's) equations: weights
``[gates·hidden, in]`` and ``[gates·hidden, hidden]`` (torch's layout, so
they carry across from JAX as they are), LSTM gates in the order i, f, g,
o, GRU gates r, z, c with the reset gate on the hidden projection and
``h' = (1 − z)·c + z·h``. :class:`RNN` and :class:`BiRNN` run any cell one
step at a time, as JAX's ``lax.scan`` does. The stacked layers
(:class:`SimpleRNN`, :class:`LSTM`, :class:`GRU`) run each layer, both
directions, as torch's fused recurrence (cuDNN on the card; JAX runs
``lax.scan`` there, no TPU kernel), with dropout between layers drawn from
the port's key stream (:func:`~.functional.dropout`).

Layout: inputs ``[batch, time, size]`` (``time_major=False``), as in JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import _VF

from ..core.device import resolve_device
from . import functional as F
from . import initializer as I
from .layer import Layer, create_parameter
from .layers import LayerList

__all__ = ["SimpleRNNCell", "LSTMCell", "GRUCell", "RNN", "BiRNN",
           "SimpleRNN", "LSTM", "GRU"]


class _RNNCellBase(Layer):
    """Weights ``weight_ih [g, in]``, ``weight_hh [g, hidden]`` and biases
    ``[g]`` (``g = gates·hidden``), all U(±1/sqrt(hidden)) by default; a
    bias attribute of False leaves that bias out."""

    def __init__(self, input_size: int, hidden_size: int, n_gates: int,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, dtype=None, *,
                 device=None):
        super().__init__(dtype=dtype)
        device = resolve_device(device)
        self.input_size, self.hidden_size = input_size, hidden_size
        k = 1.0 / math.sqrt(hidden_size)
        g = n_gates * hidden_size

        def param(shape, attr, is_bias=False):
            if attr is False:
                return None
            return create_parameter(shape, attr, dtype, is_bias=is_bias,
                                    default_initializer=I.Uniform(-k, k),
                                    device=device)

        self.weight_ih = param((g, input_size), weight_ih_attr)
        self.weight_hh = param((g, hidden_size), weight_hh_attr)
        self.bias_ih = param((g,), bias_ih_attr, True)
        self.bias_hh = param((g,), bias_hh_attr, True)

    def _proj(self, x, h):
        gi = x @ self.weight_ih.T
        gh = h @ self.weight_hh.T
        if self.bias_ih is not None:
            gi = gi + self.bias_ih
        if self.bias_hh is not None:
            gh = gh + self.bias_hh
        return gi, gh

    def get_initial_states(self, batch: int, dtype=torch.float32):
        z = torch.zeros((batch, self.hidden_size), dtype=dtype,
                        device=self.weight_ih.device)
        if len(self.state_shape) > 1:
            return tuple(z.clone() for _ in self.state_shape)
        return z   # single-state cells carry a bare h


class SimpleRNNCell(_RNNCellBase):
    """``h' = act(W_ih x + b_ih + W_hh h + b_hh)``, act tanh or relu."""

    state_shape = ("h",)

    def __init__(self, input_size, hidden_size, activation: str = "tanh",
                 **kwargs):
        super().__init__(input_size, hidden_size, 1, **kwargs)
        if activation not in ("tanh", "relu"):
            raise ValueError("activation must be tanh or relu")
        self.activation = activation

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs.shape[0], inputs.dtype)
        if isinstance(h, (tuple, list)):
            h = h[0]
        gi, gh = self._proj(inputs, h)
        h_new = torch.tanh(gi + gh) if self.activation == "tanh" else \
            F.relu(gi + gh)
        return h_new, h_new


class LSTMCell(_RNNCellBase):
    """Gates (i, f, g, o); returns ``(h, (h, c))``."""

    state_shape = ("h", "c")

    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__(input_size, hidden_size, 4, **kwargs)

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs.shape[0], inputs.dtype)
        h, c = states
        gi, gh = self._proj(inputs, h)
        i, f, g, o = torch.chunk(gi + gh, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)


class GRUCell(_RNNCellBase):
    """Gates (r, z, c); the reset gate scales the candidate's hidden
    projection."""

    state_shape = ("h",)

    def __init__(self, input_size, hidden_size, **kwargs):
        super().__init__(input_size, hidden_size, 3, **kwargs)

    def forward(self, inputs, states=None):
        h = states if states is not None else \
            self.get_initial_states(inputs.shape[0], inputs.dtype)
        if isinstance(h, (tuple, list)):
            h = h[0]
        gi, gh = self._proj(inputs, h)
        i_r, i_z, i_c = torch.chunk(gi, 3, dim=-1)
        h_r, h_z, h_c = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        c = torch.tanh(i_c + r * h_c)
        h_new = (1.0 - z) * c + z * h
        return h_new, h_new


def _run_cell(cell, inputs, states, reverse: bool = False):
    """``cell`` over the time axis of ``[B, T, C]`` one step at a time (the
    last step first with ``reverse``; the outputs stay in time order).
    Returns ``(outputs [B, T, H], final states)``."""
    steps = range(inputs.shape[1])
    outs = [None] * inputs.shape[1]
    for t in (reversed(steps) if reverse else steps):
        outs[t], states = cell(inputs[:, t], states)
    return torch.stack(outs, dim=1), states


class RNN(Layer):
    """A cell over ``(batch, time, size)`` inputs."""

    def __init__(self, cell, is_reverse: bool = False,
                 time_major: bool = False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = inputs.transpose(0, 1)
        if initial_states is None:
            initial_states = self.cell.get_initial_states(inputs.shape[0],
                                                          inputs.dtype)
        out, final = _run_cell(self.cell, inputs, initial_states,
                               self.is_reverse)
        return (out.transpose(0, 1) if self.time_major else out), final


class BiRNN(Layer):
    """A forward and a backward cell, their outputs concatenated."""

    def __init__(self, cell_fw, cell_bw, time_major: bool = False):
        super().__init__()
        self.cell_fw, self.cell_bw = cell_fw, cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = inputs.transpose(0, 1)
        if initial_states is None:
            b = inputs.shape[0]
            states_fw = self.cell_fw.get_initial_states(b, inputs.dtype)
            states_bw = self.cell_bw.get_initial_states(b, inputs.dtype)
        else:
            states_fw, states_bw = initial_states
        out_fw, fin_fw = _run_cell(self.cell_fw, inputs, states_fw)
        out_bw, fin_bw = _run_cell(self.cell_bw, inputs, states_bw,
                                   reverse=True)
        out = torch.cat([out_fw, out_bw], dim=-1)
        return (out.transpose(0, 1) if self.time_major else out), \
            (fin_fw, fin_bw)


_FUSED = {"LSTMCell": _VF.lstm, "GRUCell": _VF.gru}


class _StackedRNNBase(Layer):
    """``num_layers`` layers of cells (two a layer when bidirectional),
    kept as JAX keeps them (``cells.<layer·dirs + dir>.weight_ih``, ...),
    run a layer at a time by torch's fused recurrence; dropout between
    layers from the key stream. ``initial_states`` and the final states are
    ``[layers·dirs, B, H]`` (a pair of them for LSTM)."""

    _cell_cls = None
    _n_states = 1

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 time_major: bool = False, dropout: float = 0.0,
                 activation: Optional[str] = None,
                 weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, dtype=None, *,
                 device=None):
        super().__init__(dtype=dtype)
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        device = resolve_device(device)
        self.bidirectional = direction != "forward"
        self.num_layers, self.time_major = num_layers, time_major
        self.dropout, self.hidden_size = dropout, hidden_size
        n_dir = 2 if self.bidirectional else 1
        kwargs = dict(weight_ih_attr=weight_ih_attr,
                      weight_hh_attr=weight_hh_attr,
                      bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                      dtype=dtype, device=device)
        if activation is not None:
            kwargs["activation"] = activation
        self.cells = LayerList([
            self._cell_cls(input_size if layer == 0 else hidden_size * n_dir,
                           hidden_size, **kwargs)
            for layer in range(num_layers) for _ in range(n_dir)])

    def _fused(self):
        name = type(self.cells[0]).__name__
        if name == "SimpleRNNCell":
            return _VF.rnn_tanh if self.cells[0].activation == "tanh" \
                else _VF.rnn_relu
        return _FUSED[name]

    def _weights(self, cells):
        """The fused op's flat weights: ``w_ih, w_hh, b_ih, b_hh`` a cell
        (a missing bias as zeros when the other is there)."""
        flat, has_bias = [], any(c.bias_ih is not None or
                                 c.bias_hh is not None for c in cells)
        for c in cells:
            flat += [c.weight_ih, c.weight_hh]
            if has_bias:
                zero = c.weight_ih.new_zeros(c.weight_ih.shape[0])
                flat += [c.bias_ih if c.bias_ih is not None else zero,
                         c.bias_hh if c.bias_hh is not None else zero]
        return flat, has_bias

    def forward(self, inputs, initial_states=None):
        if self.time_major:
            inputs = inputs.transpose(0, 1)
        n_dir = 2 if self.bidirectional else 1
        b = inputs.shape[0]
        fused = self._fused()
        out, finals = inputs, []
        for layer in range(self.num_layers):
            lo, hi = layer * n_dir, (layer + 1) * n_dir
            flat, has_bias = self._weights(
                [self.cells[i] for i in range(lo, hi)])
            if initial_states is None:
                h0 = out.new_zeros((n_dir, b, self.hidden_size))
                hx = (h0, h0.clone()) if self._n_states == 2 else h0
            elif self._n_states == 2:
                hx = (initial_states[0][lo:hi], initial_states[1][lo:hi])
            else:
                hx = initial_states[lo:hi]
            res = fused(out, hx, flat, has_bias, 1, 0.0, self.training,
                        self.bidirectional, True)
            out = res[0]
            finals.append(res[1:] if self._n_states == 2 else res[1])
            if self.dropout and layer != self.num_layers - 1 \
                    and self.training:
                out = F.dropout(out, self.dropout, training=True)
        if self._n_states == 2:
            final = (torch.cat([f[0] for f in finals]),
                     torch.cat([f[1] for f in finals]))
        else:
            final = torch.cat(finals)
        return (out.transpose(0, 1) if self.time_major else out), final


class SimpleRNN(_StackedRNNBase):
    _cell_cls = SimpleRNNCell
    _n_states = 1

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kwargs):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation,
                         **kwargs)


class LSTM(_StackedRNNBase):
    _cell_cls = LSTMCell
    _n_states = 2


class GRU(_StackedRNNBase):
    _cell_cls = GRUCell
    _n_states = 1
