# -*- coding: utf-8 -*-
# Generated by elasticdl_tpu/proto/gen_pb2.py (no protoc on this image —
# the serialized descriptor is patched programmatically; schema source of
# truth: elasticdl_tpu.proto).  DO NOT EDIT BY HAND.
# source: elasticdl_tpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13elasticdl_tpu.proto\x12\relasticdl_tpu"\x92\x01\n\x04Task\x12\x0f\n\x07task_id\x18\x01 \x01(\x05\x12%\n\x04type\x18\x02 \x01(\x0e2\x17.elasticdl_tpu.TaskType\x12\x12\n\nshard_name\x18\x03 \x01(\t\x12\r\n\x05start\x18\x04 \x01(\x03\x12\x0b\n\x03end\x18\x05 \x01(\x03\x12\r\n\x05epoch\x18\x06 \x01(\x05\x12\x13\n\x0beval_job_id\x18\x07 \x01(\x05"\x96\x01\n\x15RegisterWorkerRequest\x12\x13\n\x0bworker_name\x18\x01 \x01(\t\x12\x1d\n\x15preferred_id_plus_one\x18\x02 \x01(\x05\x12!\n\x0cmember_names\x18\x03 \x03(\tR\x0bmemberNames\x12&\n\x0fdata_plane_addr\x18\x04 \x01(\tR\rdataPlaneAddr"{\n\x16RegisterWorkerResponse\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x1a\n\x12membership_version\x18\x02 \x01(\x03\x12\x13\n\x0bnum_workers\x18\x03 \x01(\x05\x12\x1d\n\nmember_ids\x18\x04 \x03(\x05R\tmemberIds"@\n\x0eGetTaskRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x1b\n\tmax_tasks\x18\x02 \x01(\x05R\x08maxTasks"\x8a\x01\n\x0fGetTaskResponse\x12!\n\x04task\x18\x01 \x01(\x0b2\x13.elasticdl_tpu.Task\x12\x10\n\x08job_done\x18\x02 \x01(\x08\x12\x17\n\x0fbackoff_seconds\x18\x03 \x01(\x02\x12)\n\x05tasks\x18\x04 \x03(\x0b2\x13.elasticdl_tpu.TaskR\x05tasks"\xf9\x01\n\x17ReportTaskResultRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x0f\n\x07task_id\x18\x02 \x01(\x05\x12\x0f\n\x07success\x18\x03 \x01(\x08\x12\x13\n\x0berr_message\x18\x04 \x01(\t\x12\x19\n\x11records_processed\x18\x05 \x01(\x03\x12\x15\n\rmodel_version\x18\x06 \x01(\x05\x12\x10\n\x08loss_sum\x18\x07 \x01(\x02\x12\x12\n\nloss_count\x18\x08 \x01(\x03\x12\x11\n\tpreempted\x18\t \x01(\x08\x12\x15\n\rstep_time_sum\x18\n \x01(\x01\x12\x12\n\nstep_count\x18\x0b \x01(\x03",\n\x18ReportTaskResultResponse\x12\x10\n\x08accepted\x18\x01 \x01(\x08")\n\x0bMetricState\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0c\n\x04data\x18\x02 \x01(\x0c"\x85\x01\n\x1eReportEvaluationMetricsRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x13\n\x0beval_job_id\x18\x02 \x01(\x05\x12*\n\x06states\x18\x03 \x03(\x0b2\x1a.elasticdl_tpu.MetricState\x12\x0f\n\x07task_id\x18\x04 \x01(\x05"!\n\x1fReportEvaluationMetricsResponse"q\n\x10HeartbeatRequest\x12\x11\n\tworker_id\x18\x01 \x01(\x05\x12\x15\n\rmodel_version\x18\x02 \x01(\x05\x123\n\x07members\x18\x03 \x03(\x0b2\x19.elasticdl_tpu.MemberBeatR\x07members"\xb0\x01\n\x11HeartbeatResponse\x12\x1a\n\x12membership_version\x18\x01 \x01(\x03\x12\x13\n\x0bnum_workers\x18\x02 \x01(\x05\x12\x19\n\x11should_checkpoint\x18\x03 \x01(\x08\x12\x10\n\x08shutdown\x18\x04 \x01(\x08\x12\x10\n\x08job_done\x18\x05 \x01(\x08\x12\x15\n\rlearning_rate\x18\x06 \x01(\x01\x12\x14\n\x05evict\x18\x07 \x01(\x08R\x05evict"\x07\n\x05Empty"\x9a\x02\n\x11JobStatusResponse\x12\x10\n\x08job_done\x18\x01 \x01(\x08\x12\x1f\n\x17finished_training_tasks\x18\x02 \x01(\x05\x12\x15\n\rpending_tasks\x18\x03 \x01(\x05\x12\x13\n\x0bdoing_tasks\x18\x04 \x01(\x05\x12\r\n\x05epoch\x18\x05 \x01(\x05\x12\x1a\n\x12membership_version\x18\x06 \x01(\x03\x12G\n\x0ceval_metrics\x18\x07 \x03(\x0b21.elasticdl_tpu.JobStatusResponse.EvalMetricsEntry\x1a2\n\x10EvalMetricsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x02:\x028\x01"m\n\nMemberBeat\x12\x1b\n\tworker_id\x18\x01 \x01(\x05R\x08workerId\x12#\n\rmodel_version\x18\x02 \x01(\x05R\x0cmodelVersion\x12\x1d\n\nstats_json\x18\x03 \x01(\tR\tstatsJson"\x83\x01\n\x12EmbeddingTableSpec\x12\x12\n\x04name\x18\x01 \x01(\tR\x04name\x12\x14\n\x05vocab\x18\x02 \x01(\x05R\x05vocab\x12\x10\n\x03dim\x18\x03 \x01(\x05R\x03dim\x12\x12\n\x04seed\x18\x04 \x01(\x05R\x04seed\x12\x1d\n\ninit_scale\x18\x05 \x01(\x02R\tinitScale":\n\x1bGetEmbeddingShardMapRequest\x12\x1b\n\tworker_id\x18\x01 \x01(\x05R\x08workerId"\xf8\x02\n\x1cGetEmbeddingShardMapResponse\x12\x18\n\x07version\x18\x01 \x01(\x05R\x07version\x12\x1d\n\nnum_shards\x18\x02 \x01(\x05R\tnumShards\x12!\n\x0cshard_owners\x18\x03 \x03(\x05R\x0bshardOwners\x129\n\x06tables\x18\x04 \x03(\x0b2!.elasticdl_tpu.EmbeddingTableSpecR\x06tables\x12\x1e\n\nresharding\x18\x05 \x01(\x08R\nresharding\x12#\n\rreplica_count\x18\x06 \x01(\x05R\x0creplicaCount\x12%\n\x0eshard_replicas\x18\x07 \x03(\x05R\rshardReplicas\x12&\n\x0faddr_worker_ids\x18\x08 \x03(\x05R\raddrWorkerIds\x12\x14\n\x05addrs\x18\t \x03(\tR\x05addrs\x12\x17\n\x07hot_ids\x18\n \x03(\x03R\x06hotIds"s\n\x1dReportEmbeddingReshardRequest\x12\x1b\n\tworker_id\x18\x01 \x01(\x05R\x08workerId\x12\x18\n\x07version\x18\x02 \x01(\x05R\x07version\x12\x1b\n\tshard_ids\x18\x03 \x03(\x05R\x08shardIds"<\n\x1eReportEmbeddingReshardResponse\x12\x1a\n\x08accepted\x18\x01 \x01(\x08R\x08accepted"\xb6\x01\n\x14EmbeddingPullRequest\x12\x14\n\x05table\x18\x01 \x01(\tR\x05table\x12\x14\n\x05shard\x18\x02 \x01(\x05R\x05shard\x12\x10\n\x03ids\x18\x03 \x01(\x0cR\x03ids\x12\x1f\n\x0bmap_version\x18\x04 \x01(\x05R\nmapVersion\x12%\n\x0ewith_watermark\x18\x05 \x01(\x08R\rwithWatermark\x12\x18\n\x07replica\x18\x06 \x01(\x08R\x07replica"M\n\x15EmbeddingPullResponse\x12\x12\n\x04rows\x18\x01 \x01(\x0cR\x04rows\x12\x10\n\x03dim\x18\x02 \x01(\x05R\x03dim\x12\x0e\n\x02wm\x18\x03 \x01(\x03R\x02wm"\x87\x02\n\x14EmbeddingPushRequest\x12\x14\n\x05table\x18\x01 \x01(\tR\x05table\x12\x14\n\x05shard\x18\x02 \x01(\x05R\x05shard\x12\x10\n\x03ids\x18\x03 \x01(\x0cR\x03ids\x12\x12\n\x04rows\x18\x04 \x01(\x0cR\x04rows\x12\x10\n\x03dim\x18\x05 \x01(\x05R\x03dim\x12\x1b\n\tclient_id\x18\x06 \x01(\tR\x08clientId\x12\x10\n\x03seq\x18\x07 \x01(\x03R\x03seq\x12\x1f\n\x0bmap_version\x18\x08 \x01(\x05R\nmapVersion\x12\x14\n\x05scale\x18\t \x01(\x02R\x05scale\x12%\n\x0ewith_watermark\x18\n \x01(\x08R\rwithWatermark"A\n\x15EmbeddingPushResponse\x12\x18\n\x07applied\x18\x01 \x01(\x08R\x07applied\x12\x0e\n\x02wm\x18\x02 \x01(\x03R\x02wm"b\n\x1aEmbeddingFetchShardRequest\x12\x14\n\x05table\x18\x01 \x01(\tR\x05table\x12\x14\n\x05shard\x18\x02 \x01(\x05R\x05shard\x12\x18\n\x07replica\x18\x03 \x01(\x08R\x07replica"\x8d\x01\n\x1bEmbeddingFetchShardResponse\x12\x12\n\x04rows\x18\x01 \x01(\x0cR\x04rows\x12\x15\n\x06rows_n\x18\x02 \x01(\x05R\x05rowsN\x12\x10\n\x03dim\x18\x03 \x01(\x05R\x03dim\x12!\n\x0capplied_json\x18\x04 \x01(\tR\x0bappliedJson\x12\x0e\n\x02wm\x18\x05 \x01(\x03R\x02wm"\xa2\x01\n\x13EmbeddingDeltaEntry\x12\x0e\n\x02wm\x18\x01 \x01(\x03R\x02wm\x12\x10\n\x03ids\x18\x02 \x01(\x0cR\x03ids\x12\x12\n\x04rows\x18\x03 \x01(\x0cR\x04rows\x12\x10\n\x03dim\x18\x04 \x01(\x05R\x03dim\x12\x14\n\x05scale\x18\x05 \x01(\x02R\x05scale\x12\x1b\n\tclient_id\x18\x06 \x01(\tR\x08clientId\x12\x10\n\x03seq\x18\x07 \x01(\x03R\x03seq"c\n\x1aEmbeddingFetchDeltaRequest\x12\x14\n\x05table\x18\x01 \x01(\tR\x05table\x12\x14\n\x05shard\x18\x02 \x01(\x05R\x05shard\x12\x19\n\x08since_wm\x18\x03 \x01(\x03R\x07sinceWm"\x81\x01\n\x1bEmbeddingFetchDeltaResponse\x12\x14\n\x05found\x18\x01 \x01(\x08R\x05found\x12\x0e\n\x02wm\x18\x02 \x01(\x03R\x02wm\x12<\n\x07entries\x18\x03 \x03(\x0b2".elasticdl_tpu.EmbeddingDeltaEntryR\x07entries"a\n\x19EmbeddingWatermarkRequest\x12\x14\n\x05table\x18\x01 \x01(\tR\x05table\x12\x14\n\x05shard\x18\x02 \x01(\x05R\x05shard\x12\x18\n\x07replica\x18\x03 \x01(\x08R\x07replica",\n\x1aEmbeddingWatermarkResponse\x12\x0e\n\x02wm\x18\x01 \x01(\x03R\x02wm"\xb0\x01\n\x19EmbeddingPullMultiRequest\x12\x16\n\x06tables\x18\x01 \x03(\tR\x06tables\x12\x16\n\x06shards\x18\x02 \x03(\x05R\x06shards\x12\x16\n\x06counts\x18\x03 \x03(\x05R\x06counts\x12\x10\n\x03ids\x18\x04 \x01(\x0cR\x03ids\x12\x1f\n\x0bmap_version\x18\x05 \x01(\x05R\nmapVersion\x12\x18\n\x07replica\x18\x06 \x01(\x08R\x07replica"\xad\x01\n\x1aEmbeddingPullMultiResponse\x12\x12\n\x04rows\x18\x01 \x01(\x0cR\x04rows\x12\x12\n\x04dims\x18\x02 \x03(\x05R\x04dims\x12\x10\n\x03wms\x18\x03 \x03(\x03R\x03wms\x12\x1b\n\twm_tables\x18\x04 \x03(\tR\x08wmTables\x12\x1b\n\twm_shards\x18\x05 \x03(\x05R\x08wmShards\x12\x1b\n\twm_values\x18\x06 \x03(\x03R\x08wmValues"j\n\x1eEmbeddingWatermarkMultiRequest\x12\x16\n\x06tables\x18\x01 \x03(\tR\x06tables\x12\x16\n\x06shards\x18\x02 \x03(\x05R\x06shards\x12\x18\n\x07replica\x18\x03 \x01(\x08R\x07replica"3\n\x1fEmbeddingWatermarkMultiResponse\x12\x10\n\x03wms\x18\x01 \x03(\x03R\x03wms"\xb1\x01\n\x13EmbeddingShardChunk\x12\x12\n\x04rows\x18\x01 \x01(\x0cR\x04rows\x12\x16\n\x06offset\x18\x02 \x01(\x05R\x06offset\x12\x15\n\x06rows_n\x18\x03 \x01(\x05R\x05rowsN\x12\x10\n\x03dim\x18\x04 \x01(\x05R\x03dim\x12!\n\x0capplied_json\x18\x05 \x01(\tR\x0bappliedJson\x12\x0e\n\x02wm\x18\x06 \x01(\x03R\x02wm\x12\x12\n\x04last\x18\x07 \x01(\x08R\x04last"\x8d\x01\n\x13EmbeddingDeltaChunk\x12\x14\n\x05found\x18\x01 \x01(\x08R\x05found\x12\x0e\n\x02wm\x18\x02 \x01(\x03R\x02wm\x12<\n\x07entries\x18\x03 \x03(\x0b2".elasticdl_tpu.EmbeddingDeltaEntryR\x07entries\x12\x12\n\x04last\x18\x04 \x01(\x08R\x04last"}\n\x1cEmbeddingShmNegotiateRequest\x12\x1f\n\x0bclient_host\x18\x01 \x01(\tR\nclientHost\x12\x1d\n\nclient_pid\x18\x02 \x01(\x05R\tclientPid\x12\x1d\n\nslot_bytes\x18\x03 \x01(\x05R\tslotBytes"h\n\x1dEmbeddingShmNegotiateResponse\x12\x0e\n\x02ok\x18\x01 \x01(\x08R\x02ok\x12\x18\n\x07segment\x18\x02 \x01(\tR\x07segment\x12\x1d\n\nslot_bytes\x18\x03 \x01(\x05R\tslotBytes*R\n\x08TaskType\x12\x0c\n\x08TRAINING\x10\x00\x12\x0e\n\nEVALUATION\x10\x01\x12\x0e\n\nPREDICTION\x10\x02\x12\x0e\n\nSAVE_MODEL\x10\x03\x12\x08\n\x04WAIT\x10\x042\xa8\x04\n\x06Master\x12]\n\x0eRegisterWorker\x12$.elasticdl_tpu.RegisterWorkerRequest\x1a%.elasticdl_tpu.RegisterWorkerResponse\x12H\n\x07GetTask\x12\x1d.elasticdl_tpu.GetTaskRequest\x1a\x1e.elasticdl_tpu.GetTaskResponse\x12c\n\x10ReportTaskResult\x12&.elasticdl_tpu.ReportTaskResultRequest\x1a\'.elasticdl_tpu.ReportTaskResultResponse\x12x\n\x17ReportEvaluationMetrics\x12-.elasticdl_tpu.ReportEvaluationMetricsRequest\x1a..elasticdl_tpu.ReportEvaluationMetricsResponse\x12N\n\tHeartbeat\x12\x1f.elasticdl_tpu.HeartbeatRequest\x1a .elasticdl_tpu.HeartbeatResponse\x12F\n\x0cGetJobStatus\x12\x14.elasticdl_tpu.Empty\x1a .elasticdl_tpu.JobStatusResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'elasticdl_tpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._options = None
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._serialized_options = b'8\001'
  _TASKTYPE._serialized_start=5092
  _TASKTYPE._serialized_end=5174
  _TASK._serialized_start=39
  _TASK._serialized_end=185
  _REGISTERWORKERREQUEST._serialized_start=188
  _REGISTERWORKERREQUEST._serialized_end=338
  _REGISTERWORKERRESPONSE._serialized_start=340
  _REGISTERWORKERRESPONSE._serialized_end=463
  _GETTASKREQUEST._serialized_start=465
  _GETTASKREQUEST._serialized_end=529
  _GETTASKRESPONSE._serialized_start=532
  _GETTASKRESPONSE._serialized_end=670
  _REPORTTASKRESULTREQUEST._serialized_start=673
  _REPORTTASKRESULTREQUEST._serialized_end=922
  _REPORTTASKRESULTRESPONSE._serialized_start=924
  _REPORTTASKRESULTRESPONSE._serialized_end=968
  _METRICSTATE._serialized_start=970
  _METRICSTATE._serialized_end=1011
  _REPORTEVALUATIONMETRICSREQUEST._serialized_start=1014
  _REPORTEVALUATIONMETRICSREQUEST._serialized_end=1147
  _REPORTEVALUATIONMETRICSRESPONSE._serialized_start=1149
  _REPORTEVALUATIONMETRICSRESPONSE._serialized_end=1182
  _HEARTBEATREQUEST._serialized_start=1184
  _HEARTBEATREQUEST._serialized_end=1297
  _HEARTBEATRESPONSE._serialized_start=1300
  _HEARTBEATRESPONSE._serialized_end=1476
  _EMPTY._serialized_start=1478
  _EMPTY._serialized_end=1485
  _JOBSTATUSRESPONSE._serialized_start=1488
  _JOBSTATUSRESPONSE._serialized_end=1770
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._serialized_start=1720
  _JOBSTATUSRESPONSE_EVALMETRICSENTRY._serialized_end=1770
  _MEMBERBEAT._serialized_start=1772
  _MEMBERBEAT._serialized_end=1881
  _EMBEDDINGTABLESPEC._serialized_start=1884
  _EMBEDDINGTABLESPEC._serialized_end=2015
  _GETEMBEDDINGSHARDMAPREQUEST._serialized_start=2017
  _GETEMBEDDINGSHARDMAPREQUEST._serialized_end=2075
  _GETEMBEDDINGSHARDMAPRESPONSE._serialized_start=2078
  _GETEMBEDDINGSHARDMAPRESPONSE._serialized_end=2454
  _REPORTEMBEDDINGRESHARDREQUEST._serialized_start=2456
  _REPORTEMBEDDINGRESHARDREQUEST._serialized_end=2571
  _REPORTEMBEDDINGRESHARDRESPONSE._serialized_start=2573
  _REPORTEMBEDDINGRESHARDRESPONSE._serialized_end=2633
  _EMBEDDINGPULLREQUEST._serialized_start=2636
  _EMBEDDINGPULLREQUEST._serialized_end=2818
  _EMBEDDINGPULLRESPONSE._serialized_start=2820
  _EMBEDDINGPULLRESPONSE._serialized_end=2897
  _EMBEDDINGPUSHREQUEST._serialized_start=2900
  _EMBEDDINGPUSHREQUEST._serialized_end=3163
  _EMBEDDINGPUSHRESPONSE._serialized_start=3165
  _EMBEDDINGPUSHRESPONSE._serialized_end=3230
  _EMBEDDINGFETCHSHARDREQUEST._serialized_start=3232
  _EMBEDDINGFETCHSHARDREQUEST._serialized_end=3330
  _EMBEDDINGFETCHSHARDRESPONSE._serialized_start=3333
  _EMBEDDINGFETCHSHARDRESPONSE._serialized_end=3474
  _EMBEDDINGDELTAENTRY._serialized_start=3477
  _EMBEDDINGDELTAENTRY._serialized_end=3639
  _EMBEDDINGFETCHDELTAREQUEST._serialized_start=3641
  _EMBEDDINGFETCHDELTAREQUEST._serialized_end=3740
  _EMBEDDINGFETCHDELTARESPONSE._serialized_start=3743
  _EMBEDDINGFETCHDELTARESPONSE._serialized_end=3872
  _EMBEDDINGWATERMARKREQUEST._serialized_start=3874
  _EMBEDDINGWATERMARKREQUEST._serialized_end=3971
  _EMBEDDINGWATERMARKRESPONSE._serialized_start=3973
  _EMBEDDINGWATERMARKRESPONSE._serialized_end=4017
  _EMBEDDINGPULLMULTIREQUEST._serialized_start=4020
  _EMBEDDINGPULLMULTIREQUEST._serialized_end=4196
  _EMBEDDINGPULLMULTIRESPONSE._serialized_start=4199
  _EMBEDDINGPULLMULTIRESPONSE._serialized_end=4372
  _EMBEDDINGWATERMARKMULTIREQUEST._serialized_start=4374
  _EMBEDDINGWATERMARKMULTIREQUEST._serialized_end=4480
  _EMBEDDINGWATERMARKMULTIRESPONSE._serialized_start=4482
  _EMBEDDINGWATERMARKMULTIRESPONSE._serialized_end=4533
  _EMBEDDINGSHARDCHUNK._serialized_start=4536
  _EMBEDDINGSHARDCHUNK._serialized_end=4713
  _EMBEDDINGDELTACHUNK._serialized_start=4716
  _EMBEDDINGDELTACHUNK._serialized_end=4857
  _EMBEDDINGSHMNEGOTIATEREQUEST._serialized_start=4859
  _EMBEDDINGSHMNEGOTIATEREQUEST._serialized_end=4984
  _EMBEDDINGSHMNEGOTIATERESPONSE._serialized_start=4986
  _EMBEDDINGSHMNEGOTIATERESPONSE._serialized_end=5090

# @@protoc_insertion_point(module_scope)
