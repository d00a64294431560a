"""asr_decoder_tpu_torch — the streaming ASR decoder in PyTorch and CUDA.

A port of ``asr_decoder_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch on an
NVIDIA Hopper GPU.  The JAX package stays the reference: each module here
mirrors the module of the same name there, and the tests hold each one to
its JAX counterpart on identical inputs.  This package imports ``torch``
and nothing of ``jax`` or of ``asr_decoder_tpu``.

Ported (module for module):
  ops/gather.py, ops/fetch.py  — hand-written CUDA kernels (csrc/*.cu for
                                 sm_90a, built at first use by ops/_build.py)
                                 with their plain PyTorch versions; the
                                 gather takes up to 8 tables that share an
                                 index in one launch (batched_table_gather_
                                 many); the fetch kernel also serves the row
                                 gather of tools/perf (ops/fetch.py:
                                 row_gather)
  ops/beamsearch.py            — both search engines: v3 (relax_impl=topk)
                                 and v2 (relax_impl=sort) in closure and
                                 sweeps ε mode, with the JAX auto rules
  ops/beamsearch_clg.py        — the clg graph type: CLG ⊗ HMM composed on
                                 the fly (v2 relax, ε sweeps)
  ops/beamsearch_biglm.py      — the biglm-hclg graph type: HCLG ⊗ (G₂−G₁)
                                 pair search, LM-candidate compaction
  lm/device_lm.py              — device n-gram LM tables (hash, unigram,
                                 backoff) and the difference LM
  models/layers.py, nnet.py    — all 13 layer kinds and their constructors,
                                 the Nnet binary format, am_forward,
                                 pack_nonblank_frames (CTC blank-frame
                                 packing), from/to_numpy_layers
  models/flagship.py           — make_flagship and the CTC training step
                                 (flagship_logits, ctc_loss — optax's, op
                                 for op — ctc_loss_fn, ctc_train_step,
                                 init_opt_state: torch.optim.Adam; on the
                                 card one captured CUDA graph a step)
  eval/harness.py              — train_ctc_model and evaluate_wer on one
                                 device (WER, RTF, gold-decoder parity)
  frontend/fbank.py            — fbank, streaming fbank, live/utterance CMVN
  frontend/pitch.py            — Kaldi pitch: resampler, NCCF, Viterbi lag
                                 tracking, POV post-processing, StreamPitch,
                                 ArbitraryResample (full f32 on the card)
  frontend/pipeline.py         — fbank + CMVN (‖ pitch) (+ deltas)
  vad/energy.py, model_vad.py  — the energy VAD and the nnet VAD (window
                                 sums on the device, the hysteresis FSM on
                                 the host), the segment post-ops
  wakeup/dtw.py                — keyword wakeup by posterior DTW
  serving/session.py, batcher.py, server.py — the streaming serve path
                                 (hclg, clg and biglm-hclg graphs, one
                                 device), with energy-VAD endpointing:
                                 MIDDLEEND replies, text and alignment
                                 accumulated across segments
  serving/batcher.py ``mesh=``  — the arena dp-sharded over a device mesh
  serving/v1_session.py        — the VAD-orchestrated V1 session
  cli/_model.py, serve.py, decode.py (``--hmmfst-file`` loads a clg graph)
  utils/profiling.py           — torch.profiler ranges and Chrome traces
  tools/bench.py, tools/eval.py — the offline tools (the JAX package's
                                 root bench.py and eval.py): the three
                                 operating points end to end, and train →
                                 decode → WER → gold parity
  tools/perf/*.py              — the search microbenches and operating-point
                                 tools (bench_row_gather, bench_dma_variants,
                                 bench_points, profile_production with
                                 ``--tlg``)
  parallel/mesh.py, decode.py  — a (dp, tp) mesh of torch.devices in one
                                 process: contiguous dp row blocks, search
                                 replicas a device (dp_decode), affine rows
                                 split over tp (TpAffine, shard_model)
  parallel/multihost.py,       — torch.distributed: one rank per device, a
  _mh_worker.py                  global DeviceMesh ("dp", "tp"), tp blocks
                                 joined by all_gather, the gloo/NCCL selftest;
                                 per-host arenas
  parallel/dryrun.py           — the ``__graft_entry__.py`` dry run: entry()
                                 and dryrun_multichip(n)
  native/*.cc, fst/native_nbest.py, serving/native_client.py — the C++
                                 n-shortest and streaming client (the JAX
                                 sources byte for byte, built with g++ at
                                 first use)

Copied from ``asr_decoder_tpu`` (host-only numpy; the same code, imports
rewritten, file formats unchanged): ``fst/{fst,semiring,symbol,lattice,
determinize,nbest,device_fst,clg,ctc_graph,synthetic,tlg,algorithms}.py``,
``decoder/{config,raw_lattice,gold,ref_parity}.py``,
``lm/{arpa,synth_arpa,compose}.py``, ``utils/{config,logging,wer,timer}.py``,
``serving/{protocol,client,post_service}.py``, ``cli/{lmscore,post_serve,arpa2fsa,convert_graph,
lat_compose,lmrescale}.py``, ``__main__.py`` (``python -m
asr_decoder_tpu_torch <tool>``), ``frontend/audio.py``,
``align/{word_align,phone_to_word}.py``, ``eval/synth_task.py``,
``models/transition.py``.

Nothing of ``asr_decoder_tpu`` is left to port (ROADMAP §1);
``tests/test_torch_api_coverage.py`` holds every public name of the JAX
package to its counterpart here, or to a stated reason.  The
multi-device paths are tested on the CPU (a mesh of ``["cpu"] * n``, gloo
ranks) and run on one card as a mesh whose entries repeat ``cuda:0``.
"""

__version__ = "0.1.0"
