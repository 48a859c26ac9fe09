"""The paper's own geometry for the Encoder-LSTM straggler predictor
(START §3.2, Table 4: 400 VMs, jobs of at most 10 tasks, k = 1.5,
T = 5 one-second steps)."""
PAPER = dict(n_hosts=400, max_tasks=10, k=1.5, horizon=5)
