# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: volume_server.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import remote_pb2 as remote__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13volume_server.proto\x12\x10volume_server_pb\x1a\x0cremote.proto\"A\n\x12\x42\x61tchDeleteRequest\x12\x10\n\x08\x66ile_ids\x18\x01 \x03(\t\x12\x19\n\x11skip_cookie_check\x18\x02 \x01(\x08\"F\n\x13\x42\x61tchDeleteResponse\x12/\n\x07results\x18\x01 \x03(\x0b\x32\x1e.volume_server_pb.DeleteResult\"]\n\x0c\x44\x65leteResult\x12\x0f\n\x07\x66ile_id\x18\x01 \x01(\t\x12\x0e\n\x06status\x18\x02 \x01(\x05\x12\r\n\x05\x65rror\x18\x03 \x01(\t\x12\x0c\n\x04size\x18\x04 \x01(\r\x12\x0f\n\x07version\x18\x05 \x01(\r\"-\n\x18VacuumVolumeCheckRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"2\n\x19VacuumVolumeCheckResponse\x12\x15\n\rgarbage_ratio\x18\x01 \x01(\x01\"D\n\x1aVacuumVolumeCompactRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0bpreallocate\x18\x02 \x01(\x03\"K\n\x1bVacuumVolumeCompactResponse\x12\x17\n\x0fprocessed_bytes\x18\x01 \x01(\x03\x12\x13\n\x0bload_avg_1m\x18\x02 \x01(\x02\".\n\x19VacuumVolumeCommitRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"G\n\x1aVacuumVolumeCommitResponse\x12\x14\n\x0cis_read_only\x18\x01 \x01(\x08\x12\x13\n\x0bvolume_size\x18\x02 \x01(\x04\"/\n\x1aVacuumVolumeCleanupRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1d\n\x1bVacuumVolumeCleanupResponse\"-\n\x17\x44\x65leteCollectionRequest\x12\x12\n\ncollection\x18\x01 \x01(\t\"\x1a\n\x18\x44\x65leteCollectionResponse\"\xa8\x01\n\x15\x41llocateVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0bpreallocate\x18\x03 \x01(\x03\x12\x13\n\x0breplication\x18\x04 \x01(\t\x12\x0b\n\x03ttl\x18\x05 \x01(\t\x12\x1e\n\x16memory_map_max_size_mb\x18\x06 \x01(\r\x12\x11\n\tdisk_type\x18\x07 \x01(\t\"\x18\n\x16\x41llocateVolumeResponse\",\n\x17VolumeSyncStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xa9\x01\n\x18VolumeSyncStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x04 \x01(\t\x12\x0b\n\x03ttl\x18\x05 \x01(\t\x12\x13\n\x0btail_offset\x18\x06 \x01(\x04\x12\x18\n\x10\x63ompact_revision\x18\x07 \x01(\r\x12\x15\n\ridx_file_size\x18\x08 \x01(\x04\"C\n\x1cVolumeIncrementalCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\"5\n\x1dVolumeIncrementalCopyResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\"\'\n\x12VolumeMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x15\n\x13VolumeMountResponse\")\n\x14VolumeUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x17\n\x15VolumeUnmountResponse\"<\n\x13VolumeDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\nonly_empty\x18\x02 \x01(\x08\"\x16\n\x14VolumeDeleteResponse\".\n\x19VolumeMarkReadonlyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkReadonlyResponse\".\n\x19VolumeMarkWritableRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\x1c\n\x1aVolumeMarkWritableResponse\"@\n\x16VolumeConfigureRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x13\n\x0breplication\x18\x02 \x01(\t\"(\n\x17VolumeConfigureResponse\x12\r\n\x05\x65rror\x18\x01 \x01(\t\"(\n\x13VolumeStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"q\n\x14VolumeStatusResponse\x12\x14\n\x0cis_read_only\x18\x01 \x01(\x08\x12\x13\n\x0bvolume_size\x18\x02 \x01(\x04\x12\x12\n\nfile_count\x18\x03 \x01(\x04\x12\x1a\n\x12\x66ile_deleted_count\x18\x04 \x01(\x04\"\xa5\x01\n\x11VolumeCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0breplication\x18\x03 \x01(\t\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\x12\x11\n\tdisk_type\x18\x06 \x01(\t\x12\x1a\n\x12io_byte_per_second\x18\x07 \x01(\x03\"H\n\x12VolumeCopyResponse\x12\x19\n\x11last_append_at_ns\x18\x01 \x01(\x04\x12\x17\n\x0fprocessed_bytes\x18\x02 \x01(\x03\"0\n\x1bReadVolumeFileStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\"\xff\x01\n\x1cReadVolumeFileStatusResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\"\n\x1aidx_file_timestamp_seconds\x18\x02 \x01(\x04\x12\x15\n\ridx_file_size\x18\x03 \x01(\x04\x12\"\n\x1a\x64\x61t_file_timestamp_seconds\x18\x04 \x01(\x04\x12\x15\n\rdat_file_size\x18\x05 \x01(\x04\x12\x12\n\nfile_count\x18\x06 \x01(\x04\x12\x1b\n\x13\x63ompaction_revision\x18\x07 \x01(\r\x12\x12\n\ncollection\x18\x08 \x01(\t\x12\x11\n\tdisk_type\x18\t \x01(\t\"\xb3\x01\n\x0f\x43opyFileRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0b\n\x03\x65xt\x18\x02 \x01(\t\x12\x1b\n\x13\x63ompaction_revision\x18\x03 \x01(\r\x12\x13\n\x0bstop_offset\x18\x04 \x01(\x04\x12\x12\n\ncollection\x18\x05 \x01(\t\x12\x14\n\x0cis_ec_volume\x18\x06 \x01(\x08\x12$\n\x1cignore_source_file_not_found\x18\x07 \x01(\x08\"@\n\x10\x43opyFileResponse\x12\x14\n\x0c\x66ile_content\x18\x01 \x01(\x0c\x12\x16\n\x0emodified_ts_ns\x18\x02 \x01(\x03\"[\n\x15ReadNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x05\x12\x11\n\tneedle_id\x18\x05 \x01(\x04\"-\n\x16ReadNeedleBlobResponse\x12\x13\n\x0bneedle_blob\x18\x01 \x01(\x0c\"a\n\x16WriteNeedleBlobRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0c\n\x04size\x18\x03 \x01(\x05\x12\x13\n\x0bneedle_blob\x18\x04 \x01(\x0c\"\x19\n\x17WriteNeedleBlobResponse\"+\n\x15ReadAllNeedlesRequest\x12\x12\n\nvolume_ids\x18\x01 \x03(\r\"c\n\x16ReadAllNeedlesResponse\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\r\x12\x13\n\x0bneedle_blob\x18\x05 \x01(\x0c\"\\\n\x17VolumeTailSenderRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\"]\n\x18VolumeTailSenderResponse\x12\x15\n\rneedle_header\x18\x01 \x01(\x0c\x12\x13\n\x0bneedle_body\x18\x02 \x01(\x0c\x12\x15\n\ris_last_chunk\x18\x03 \x01(\x08\"|\n\x19VolumeTailReceiverRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08since_ns\x18\x02 \x01(\x04\x12\x1c\n\x14idle_timeout_seconds\x18\x03 \x01(\r\x12\x1c\n\x14source_volume_server\x18\x04 \x01(\t\"\x1c\n\x1aVolumeTailReceiverResponse\"r\n\x1dVolumeEcShardsGenerateRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x13\n\x0b\x64\x61ta_shards\x18\x03 \x01(\r\x12\x15\n\rparity_shards\x18\x04 \x01(\r\" \n\x1eVolumeEcShardsGenerateResponse\"E\n\x1cVolumeEcShardsRebuildRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\":\n\x1dVolumeEcShardsRebuildResponse\x12\x19\n\x11rebuilt_shard_ids\x18\x01 \x03(\r\"\xb4\x01\n\x19VolumeEcShardsCopyRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\x12\x15\n\rcopy_ecx_file\x18\x04 \x01(\x08\x12\x18\n\x10source_data_node\x18\x05 \x01(\t\x12\x15\n\rcopy_ecj_file\x18\x06 \x01(\x08\x12\x15\n\rcopy_vif_file\x18\x07 \x01(\x08\"\x1c\n\x1aVolumeEcShardsCopyResponse\"W\n\x1bVolumeEcShardsDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1e\n\x1cVolumeEcShardsDeleteResponse\"V\n\x1aVolumeEcShardsMountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1d\n\x1bVolumeEcShardsMountResponse\"D\n\x1cVolumeEcShardsUnmountRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tshard_ids\x18\x03 \x03(\r\"\x1f\n\x1dVolumeEcShardsUnmountResponse\"o\n\x18VolumeEcShardReadRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x10\n\x08shard_id\x18\x02 \x01(\r\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x03\x12\x10\n\x08\x66ile_key\x18\x05 \x01(\x04\"=\n\x19VolumeEcShardReadResponse\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x12\n\nis_deleted\x18\x02 \x01(\x08\"e\n\x19VolumeEcBlobDeleteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x10\n\x08\x66ile_key\x18\x03 \x01(\x04\x12\x0f\n\x07version\x18\x04 \x01(\r\"\x1c\n\x1aVolumeEcBlobDeleteResponse\"F\n\x1dVolumeEcShardsToVolumeRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\" \n\x1eVolumeEcShardsToVolumeResponse\"s\n\tMemStatus\x12\x12\n\ngoroutines\x18\x01 \x01(\x05\x12\x0b\n\x03\x61ll\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x04 \x01(\x04\x12\x0c\n\x04self\x18\x05 \x01(\x04\x12\x0c\n\x04heap\x18\x06 \x01(\x04\x12\r\n\x05stack\x18\x07 \x01(\x04\"\x81\x01\n\nDiskStatus\x12\x0b\n\x03\x64ir\x18\x01 \x01(\t\x12\x0b\n\x03\x61ll\x18\x02 \x01(\x04\x12\x0c\n\x04used\x18\x03 \x01(\x04\x12\x0c\n\x04\x66ree\x18\x04 \x01(\x04\x12\x14\n\x0cpercent_free\x18\x05 \x01(\x02\x12\x14\n\x0cpercent_used\x18\x06 \x01(\x02\x12\x11\n\tdisk_type\x18\x07 \x01(\t\"\x88\x01\n VolumeTierMoveDatToRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12 \n\x18\x64\x65stination_backend_name\x18\x03 \x01(\t\x12\x1b\n\x13keep_local_dat_file\x18\x04 \x01(\x08\"T\n!VolumeTierMoveDatToRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1c\n\x14processed_percentage\x18\x02 \x01(\x02\"i\n\"VolumeTierMoveDatFromRemoteRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x12\n\ncollection\x18\x02 \x01(\t\x12\x1c\n\x14keep_remote_dat_file\x18\x03 \x01(\x08\"V\n#VolumeTierMoveDatFromRemoteResponse\x12\x11\n\tprocessed\x18\x01 \x01(\x03\x12\x1c\n\x14processed_percentage\x18\x02 \x01(\x02\"\x1b\n\x19VolumeServerStatusRequest\"\xb9\x01\n\x1aVolumeServerStatusResponse\x12\x33\n\rdisk_statuses\x18\x01 \x03(\x0b\x32\x1c.volume_server_pb.DiskStatus\x12\x32\n\rmemory_status\x18\x02 \x01(\x0b\x32\x1b.volume_server_pb.MemStatus\x12\x0f\n\x07version\x18\x03 \x01(\t\x12\x13\n\x0b\x64\x61ta_center\x18\x04 \x01(\t\x12\x0c\n\x04rack\x18\x05 \x01(\t\"\x1a\n\x18VolumeServerLeaveRequest\"\x1b\n\x19VolumeServerLeaveResponse\"[\n\x15ReadNeedleMetaRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06offset\x18\x03 \x01(\x03\x12\x0c\n\x04size\x18\x04 \x01(\x05\"o\n\x16ReadNeedleMetaResponse\x12\x0e\n\x06\x63ookie\x18\x01 \x01(\r\x12\x15\n\rlast_modified\x18\x02 \x01(\x04\x12\x0b\n\x03\x63rc\x18\x03 \x01(\r\x12\x0b\n\x03ttl\x18\x04 \x01(\t\x12\x14\n\x0c\x61ppend_at_ns\x18\x05 \x01(\x04\"\xec\x02\n\x1a\x46\x65tchAndWriteNeedleRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x03 \x01(\r\x12\x0e\n\x06offset\x18\x04 \x01(\x03\x12\x0c\n\x04size\x18\x05 \x01(\x03\x12\x46\n\x08replicas\x18\x06 \x03(\x0b\x32\x34.volume_server_pb.FetchAndWriteNeedleRequest.Replica\x12\x0c\n\x04\x61uth\x18\x07 \x01(\t\x12*\n\x0bremote_conf\x18\x0f \x01(\x0b\x32\x15.remote_pb.RemoteConf\x12\x39\n\x0fremote_location\x18\x10 \x01(\x0b\x32 .remote_pb.RemoteStorageLocation\x1a=\n\x07Replica\x12\x0b\n\x03url\x18\x01 \x01(\t\x12\x12\n\npublic_url\x18\x02 \x01(\t\x12\x11\n\tgrpc_port\x18\x03 \x01(\x05\",\n\x1b\x46\x65tchAndWriteNeedleResponse\x12\r\n\x05\x65_tag\x18\x01 \x01(\t\"\xf9\x08\n\x0cQueryRequest\x12\x12\n\nselections\x18\x01 \x03(\t\x12\x15\n\rfrom_file_ids\x18\x02 \x03(\t\x12\x35\n\x06\x66ilter\x18\x03 \x01(\x0b\x32%.volume_server_pb.QueryRequest.Filter\x12N\n\x13input_serialization\x18\x04 \x01(\x0b\x32\x31.volume_server_pb.QueryRequest.InputSerialization\x12P\n\x14output_serialization\x18\x05 \x01(\x0b\x32\x32.volume_server_pb.QueryRequest.OutputSerialization\x1a\x37\n\x06\x46ilter\x12\r\n\x05\x66ield\x18\x01 \x01(\t\x12\x0f\n\x07operand\x18\x02 \x01(\t\x12\r\n\x05value\x18\x03 \x01(\t\x1a\xb5\x03\n\x12InputSerialization\x12\x18\n\x10\x63ompression_type\x18\x01 \x01(\t\x12M\n\tcsv_input\x18\x02 \x01(\x0b\x32:.volume_server_pb.QueryRequest.InputSerialization.CSVInput\x12O\n\njson_input\x18\x03 \x01(\x0b\x32;.volume_server_pb.QueryRequest.InputSerialization.JSONInput\x1a\xc9\x01\n\x08\x43SVInput\x12\x18\n\x10\x66ile_header_info\x18\x01 \x01(\t\x12\x18\n\x10record_delimiter\x18\x02 \x01(\t\x12\x17\n\x0f\x66ield_delimiter\x18\x03 \x01(\t\x12\x17\n\x0fquote_character\x18\x04 \x01(\t\x12\x1e\n\x16quote_escape_character\x18\x05 \x01(\t\x12\x10\n\x08\x63omments\x18\x06 \x01(\t\x12%\n\x1d\x61llow_quoted_record_delimiter\x18\x07 \x01(\x08\x1a\x19\n\tJSONInput\x12\x0c\n\x04type\x18\x01 \x01(\t\x1a\xf3\x02\n\x13OutputSerialization\x12P\n\ncsv_output\x18\x02 \x01(\x0b\x32<.volume_server_pb.QueryRequest.OutputSerialization.CSVOutput\x12R\n\x0bjson_output\x18\x03 \x01(\x0b\x32=.volume_server_pb.QueryRequest.OutputSerialization.JSONOutput\x1a\x8d\x01\n\tCSVOutput\x12\x14\n\x0cquote_fields\x18\x01 \x01(\t\x12\x18\n\x10record_delimiter\x18\x02 \x01(\t\x12\x17\n\x0f\x66ield_delimiter\x18\x03 \x01(\t\x12\x17\n\x0fquote_character\x18\x04 \x01(\t\x12\x1e\n\x16quote_escape_character\x18\x05 \x01(\t\x1a&\n\nJSONOutput\x12\x18\n\x10record_delimiter\x18\x01 \x01(\t\" \n\rQueriedStripe\x12\x0f\n\x07records\x18\x01 \x01(\x0c\"A\n\x19VolumeNeedleStatusRequest\x12\x11\n\tvolume_id\x18\x01 \x01(\r\x12\x11\n\tneedle_id\x18\x02 \x01(\x04\"~\n\x1aVolumeNeedleStatusResponse\x12\x11\n\tneedle_id\x18\x01 \x01(\x04\x12\x0e\n\x06\x63ookie\x18\x02 \x01(\r\x12\x0c\n\x04size\x18\x03 \x01(\r\x12\x15\n\rlast_modified\x18\x04 \x01(\x04\x12\x0b\n\x03\x63rc\x18\x05 \x01(\r\x12\x0b\n\x03ttl\x18\x06 \x01(\t\"2\n\x0bPingRequest\x12\x0e\n\x06target\x18\x01 \x01(\t\x12\x13\n\x0btarget_type\x18\x02 \x01(\t\"S\n\x0cPingResponse\x12\x15\n\rstart_time_ns\x18\x01 \x01(\x03\x12\x16\n\x0eremote_time_ns\x18\x02 \x01(\x03\x12\x14\n\x0cstop_time_ns\x18\x03 \x01(\x03\x32\xbc$\n\x0cVolumeServer\x12\\\n\x0b\x42\x61tchDelete\x12$.volume_server_pb.BatchDeleteRequest\x1a%.volume_server_pb.BatchDeleteResponse\"\x00\x12n\n\x11VacuumVolumeCheck\x12*.volume_server_pb.VacuumVolumeCheckRequest\x1a+.volume_server_pb.VacuumVolumeCheckResponse\"\x00\x12v\n\x13VacuumVolumeCompact\x12,.volume_server_pb.VacuumVolumeCompactRequest\x1a-.volume_server_pb.VacuumVolumeCompactResponse\"\x00\x30\x01\x12q\n\x12VacuumVolumeCommit\x12+.volume_server_pb.VacuumVolumeCommitRequest\x1a,.volume_server_pb.VacuumVolumeCommitResponse\"\x00\x12t\n\x13VacuumVolumeCleanup\x12,.volume_server_pb.VacuumVolumeCleanupRequest\x1a-.volume_server_pb.VacuumVolumeCleanupResponse\"\x00\x12k\n\x10\x44\x65leteCollection\x12).volume_server_pb.DeleteCollectionRequest\x1a*.volume_server_pb.DeleteCollectionResponse\"\x00\x12\x65\n\x0e\x41llocateVolume\x12\'.volume_server_pb.AllocateVolumeRequest\x1a(.volume_server_pb.AllocateVolumeResponse\"\x00\x12k\n\x10VolumeSyncStatus\x12).volume_server_pb.VolumeSyncStatusRequest\x1a*.volume_server_pb.VolumeSyncStatusResponse\"\x00\x12|\n\x15VolumeIncrementalCopy\x12..volume_server_pb.VolumeIncrementalCopyRequest\x1a/.volume_server_pb.VolumeIncrementalCopyResponse\"\x00\x30\x01\x12\\\n\x0bVolumeMount\x12$.volume_server_pb.VolumeMountRequest\x1a%.volume_server_pb.VolumeMountResponse\"\x00\x12\x62\n\rVolumeUnmount\x12&.volume_server_pb.VolumeUnmountRequest\x1a\'.volume_server_pb.VolumeUnmountResponse\"\x00\x12_\n\x0cVolumeDelete\x12%.volume_server_pb.VolumeDeleteRequest\x1a&.volume_server_pb.VolumeDeleteResponse\"\x00\x12q\n\x12VolumeMarkReadonly\x12+.volume_server_pb.VolumeMarkReadonlyRequest\x1a,.volume_server_pb.VolumeMarkReadonlyResponse\"\x00\x12q\n\x12VolumeMarkWritable\x12+.volume_server_pb.VolumeMarkWritableRequest\x1a,.volume_server_pb.VolumeMarkWritableResponse\"\x00\x12h\n\x0fVolumeConfigure\x12(.volume_server_pb.VolumeConfigureRequest\x1a).volume_server_pb.VolumeConfigureResponse\"\x00\x12_\n\x0cVolumeStatus\x12%.volume_server_pb.VolumeStatusRequest\x1a&.volume_server_pb.VolumeStatusResponse\"\x00\x12[\n\nVolumeCopy\x12#.volume_server_pb.VolumeCopyRequest\x1a$.volume_server_pb.VolumeCopyResponse\"\x00\x30\x01\x12w\n\x14ReadVolumeFileStatus\x12-.volume_server_pb.ReadVolumeFileStatusRequest\x1a..volume_server_pb.ReadVolumeFileStatusResponse\"\x00\x12U\n\x08\x43opyFile\x12!.volume_server_pb.CopyFileRequest\x1a\".volume_server_pb.CopyFileResponse\"\x00\x30\x01\x12\x65\n\x0eReadNeedleBlob\x12\'.volume_server_pb.ReadNeedleBlobRequest\x1a(.volume_server_pb.ReadNeedleBlobResponse\"\x00\x12h\n\x0fWriteNeedleBlob\x12(.volume_server_pb.WriteNeedleBlobRequest\x1a).volume_server_pb.WriteNeedleBlobResponse\"\x00\x12g\n\x0eReadAllNeedles\x12\'.volume_server_pb.ReadAllNeedlesRequest\x1a(.volume_server_pb.ReadAllNeedlesResponse\"\x00\x30\x01\x12m\n\x10VolumeTailSender\x12).volume_server_pb.VolumeTailSenderRequest\x1a*.volume_server_pb.VolumeTailSenderResponse\"\x00\x30\x01\x12q\n\x12VolumeTailReceiver\x12+.volume_server_pb.VolumeTailReceiverRequest\x1a,.volume_server_pb.VolumeTailReceiverResponse\"\x00\x12}\n\x16VolumeEcShardsGenerate\x12/.volume_server_pb.VolumeEcShardsGenerateRequest\x1a\x30.volume_server_pb.VolumeEcShardsGenerateResponse\"\x00\x12z\n\x15VolumeEcShardsRebuild\x12..volume_server_pb.VolumeEcShardsRebuildRequest\x1a/.volume_server_pb.VolumeEcShardsRebuildResponse\"\x00\x12q\n\x12VolumeEcShardsCopy\x12+.volume_server_pb.VolumeEcShardsCopyRequest\x1a,.volume_server_pb.VolumeEcShardsCopyResponse\"\x00\x12w\n\x14VolumeEcShardsDelete\x12-.volume_server_pb.VolumeEcShardsDeleteRequest\x1a..volume_server_pb.VolumeEcShardsDeleteResponse\"\x00\x12t\n\x13VolumeEcShardsMount\x12,.volume_server_pb.VolumeEcShardsMountRequest\x1a-.volume_server_pb.VolumeEcShardsMountResponse\"\x00\x12z\n\x15VolumeEcShardsUnmount\x12..volume_server_pb.VolumeEcShardsUnmountRequest\x1a/.volume_server_pb.VolumeEcShardsUnmountResponse\"\x00\x12p\n\x11VolumeEcShardRead\x12*.volume_server_pb.VolumeEcShardReadRequest\x1a+.volume_server_pb.VolumeEcShardReadResponse\"\x00\x30\x01\x12q\n\x12VolumeEcBlobDelete\x12+.volume_server_pb.VolumeEcBlobDeleteRequest\x1a,.volume_server_pb.VolumeEcBlobDeleteResponse\"\x00\x12}\n\x16VolumeEcShardsToVolume\x12/.volume_server_pb.VolumeEcShardsToVolumeRequest\x1a\x30.volume_server_pb.VolumeEcShardsToVolumeResponse\"\x00\x12\x88\x01\n\x19VolumeTierMoveDatToRemote\x12\x32.volume_server_pb.VolumeTierMoveDatToRemoteRequest\x1a\x33.volume_server_pb.VolumeTierMoveDatToRemoteResponse\"\x00\x30\x01\x12\x8e\x01\n\x1bVolumeTierMoveDatFromRemote\x12\x34.volume_server_pb.VolumeTierMoveDatFromRemoteRequest\x1a\x35.volume_server_pb.VolumeTierMoveDatFromRemoteResponse\"\x00\x30\x01\x12q\n\x12VolumeServerStatus\x12+.volume_server_pb.VolumeServerStatusRequest\x1a,.volume_server_pb.VolumeServerStatusResponse\"\x00\x12n\n\x11VolumeServerLeave\x12*.volume_server_pb.VolumeServerLeaveRequest\x1a+.volume_server_pb.VolumeServerLeaveResponse\"\x00\x12\x65\n\x0eReadNeedleMeta\x12\'.volume_server_pb.ReadNeedleMetaRequest\x1a(.volume_server_pb.ReadNeedleMetaResponse\"\x00\x12t\n\x13\x46\x65tchAndWriteNeedle\x12,.volume_server_pb.FetchAndWriteNeedleRequest\x1a-.volume_server_pb.FetchAndWriteNeedleResponse\"\x00\x12L\n\x05Query\x12\x1e.volume_server_pb.QueryRequest\x1a\x1f.volume_server_pb.QueriedStripe\"\x00\x30\x01\x12q\n\x12VolumeNeedleStatus\x12+.volume_server_pb.VolumeNeedleStatusRequest\x1a,.volume_server_pb.VolumeNeedleStatusResponse\"\x00\x12G\n\x04Ping\x12\x1d.volume_server_pb.PingRequest\x1a\x1e.volume_server_pb.PingResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'volume_server_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _BATCHDELETEREQUEST._serialized_start=55
  _BATCHDELETEREQUEST._serialized_end=120
  _BATCHDELETERESPONSE._serialized_start=122
  _BATCHDELETERESPONSE._serialized_end=192
  _DELETERESULT._serialized_start=194
  _DELETERESULT._serialized_end=287
  _VACUUMVOLUMECHECKREQUEST._serialized_start=289
  _VACUUMVOLUMECHECKREQUEST._serialized_end=334
  _VACUUMVOLUMECHECKRESPONSE._serialized_start=336
  _VACUUMVOLUMECHECKRESPONSE._serialized_end=386
  _VACUUMVOLUMECOMPACTREQUEST._serialized_start=388
  _VACUUMVOLUMECOMPACTREQUEST._serialized_end=456
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_start=458
  _VACUUMVOLUMECOMPACTRESPONSE._serialized_end=533
  _VACUUMVOLUMECOMMITREQUEST._serialized_start=535
  _VACUUMVOLUMECOMMITREQUEST._serialized_end=581
  _VACUUMVOLUMECOMMITRESPONSE._serialized_start=583
  _VACUUMVOLUMECOMMITRESPONSE._serialized_end=654
  _VACUUMVOLUMECLEANUPREQUEST._serialized_start=656
  _VACUUMVOLUMECLEANUPREQUEST._serialized_end=703
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_start=705
  _VACUUMVOLUMECLEANUPRESPONSE._serialized_end=734
  _DELETECOLLECTIONREQUEST._serialized_start=736
  _DELETECOLLECTIONREQUEST._serialized_end=781
  _DELETECOLLECTIONRESPONSE._serialized_start=783
  _DELETECOLLECTIONRESPONSE._serialized_end=809
  _ALLOCATEVOLUMEREQUEST._serialized_start=812
  _ALLOCATEVOLUMEREQUEST._serialized_end=980
  _ALLOCATEVOLUMERESPONSE._serialized_start=982
  _ALLOCATEVOLUMERESPONSE._serialized_end=1006
  _VOLUMESYNCSTATUSREQUEST._serialized_start=1008
  _VOLUMESYNCSTATUSREQUEST._serialized_end=1052
  _VOLUMESYNCSTATUSRESPONSE._serialized_start=1055
  _VOLUMESYNCSTATUSRESPONSE._serialized_end=1224
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_start=1226
  _VOLUMEINCREMENTALCOPYREQUEST._serialized_end=1293
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_start=1295
  _VOLUMEINCREMENTALCOPYRESPONSE._serialized_end=1348
  _VOLUMEMOUNTREQUEST._serialized_start=1350
  _VOLUMEMOUNTREQUEST._serialized_end=1389
  _VOLUMEMOUNTRESPONSE._serialized_start=1391
  _VOLUMEMOUNTRESPONSE._serialized_end=1412
  _VOLUMEUNMOUNTREQUEST._serialized_start=1414
  _VOLUMEUNMOUNTREQUEST._serialized_end=1455
  _VOLUMEUNMOUNTRESPONSE._serialized_start=1457
  _VOLUMEUNMOUNTRESPONSE._serialized_end=1480
  _VOLUMEDELETEREQUEST._serialized_start=1482
  _VOLUMEDELETEREQUEST._serialized_end=1542
  _VOLUMEDELETERESPONSE._serialized_start=1544
  _VOLUMEDELETERESPONSE._serialized_end=1566
  _VOLUMEMARKREADONLYREQUEST._serialized_start=1568
  _VOLUMEMARKREADONLYREQUEST._serialized_end=1614
  _VOLUMEMARKREADONLYRESPONSE._serialized_start=1616
  _VOLUMEMARKREADONLYRESPONSE._serialized_end=1644
  _VOLUMEMARKWRITABLEREQUEST._serialized_start=1646
  _VOLUMEMARKWRITABLEREQUEST._serialized_end=1692
  _VOLUMEMARKWRITABLERESPONSE._serialized_start=1694
  _VOLUMEMARKWRITABLERESPONSE._serialized_end=1722
  _VOLUMECONFIGUREREQUEST._serialized_start=1724
  _VOLUMECONFIGUREREQUEST._serialized_end=1788
  _VOLUMECONFIGURERESPONSE._serialized_start=1790
  _VOLUMECONFIGURERESPONSE._serialized_end=1830
  _VOLUMESTATUSREQUEST._serialized_start=1832
  _VOLUMESTATUSREQUEST._serialized_end=1872
  _VOLUMESTATUSRESPONSE._serialized_start=1874
  _VOLUMESTATUSRESPONSE._serialized_end=1987
  _VOLUMECOPYREQUEST._serialized_start=1990
  _VOLUMECOPYREQUEST._serialized_end=2155
  _VOLUMECOPYRESPONSE._serialized_start=2157
  _VOLUMECOPYRESPONSE._serialized_end=2229
  _READVOLUMEFILESTATUSREQUEST._serialized_start=2231
  _READVOLUMEFILESTATUSREQUEST._serialized_end=2279
  _READVOLUMEFILESTATUSRESPONSE._serialized_start=2282
  _READVOLUMEFILESTATUSRESPONSE._serialized_end=2537
  _COPYFILEREQUEST._serialized_start=2540
  _COPYFILEREQUEST._serialized_end=2719
  _COPYFILERESPONSE._serialized_start=2721
  _COPYFILERESPONSE._serialized_end=2785
  _READNEEDLEBLOBREQUEST._serialized_start=2787
  _READNEEDLEBLOBREQUEST._serialized_end=2878
  _READNEEDLEBLOBRESPONSE._serialized_start=2880
  _READNEEDLEBLOBRESPONSE._serialized_end=2925
  _WRITENEEDLEBLOBREQUEST._serialized_start=2927
  _WRITENEEDLEBLOBREQUEST._serialized_end=3024
  _WRITENEEDLEBLOBRESPONSE._serialized_start=3026
  _WRITENEEDLEBLOBRESPONSE._serialized_end=3051
  _READALLNEEDLESREQUEST._serialized_start=3053
  _READALLNEEDLESREQUEST._serialized_end=3096
  _READALLNEEDLESRESPONSE._serialized_start=3098
  _READALLNEEDLESRESPONSE._serialized_end=3197
  _VOLUMETAILSENDERREQUEST._serialized_start=3199
  _VOLUMETAILSENDERREQUEST._serialized_end=3291
  _VOLUMETAILSENDERRESPONSE._serialized_start=3293
  _VOLUMETAILSENDERRESPONSE._serialized_end=3386
  _VOLUMETAILRECEIVERREQUEST._serialized_start=3388
  _VOLUMETAILRECEIVERREQUEST._serialized_end=3512
  _VOLUMETAILRECEIVERRESPONSE._serialized_start=3514
  _VOLUMETAILRECEIVERRESPONSE._serialized_end=3542
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_start=3544
  _VOLUMEECSHARDSGENERATEREQUEST._serialized_end=3658
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_start=3660
  _VOLUMEECSHARDSGENERATERESPONSE._serialized_end=3692
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_start=3694
  _VOLUMEECSHARDSREBUILDREQUEST._serialized_end=3763
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_start=3765
  _VOLUMEECSHARDSREBUILDRESPONSE._serialized_end=3823
  _VOLUMEECSHARDSCOPYREQUEST._serialized_start=3826
  _VOLUMEECSHARDSCOPYREQUEST._serialized_end=4006
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_start=4008
  _VOLUMEECSHARDSCOPYRESPONSE._serialized_end=4036
  _VOLUMEECSHARDSDELETEREQUEST._serialized_start=4038
  _VOLUMEECSHARDSDELETEREQUEST._serialized_end=4125
  _VOLUMEECSHARDSDELETERESPONSE._serialized_start=4127
  _VOLUMEECSHARDSDELETERESPONSE._serialized_end=4157
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_start=4159
  _VOLUMEECSHARDSMOUNTREQUEST._serialized_end=4245
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_start=4247
  _VOLUMEECSHARDSMOUNTRESPONSE._serialized_end=4276
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_start=4278
  _VOLUMEECSHARDSUNMOUNTREQUEST._serialized_end=4346
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_start=4348
  _VOLUMEECSHARDSUNMOUNTRESPONSE._serialized_end=4379
  _VOLUMEECSHARDREADREQUEST._serialized_start=4381
  _VOLUMEECSHARDREADREQUEST._serialized_end=4492
  _VOLUMEECSHARDREADRESPONSE._serialized_start=4494
  _VOLUMEECSHARDREADRESPONSE._serialized_end=4555
  _VOLUMEECBLOBDELETEREQUEST._serialized_start=4557
  _VOLUMEECBLOBDELETEREQUEST._serialized_end=4658
  _VOLUMEECBLOBDELETERESPONSE._serialized_start=4660
  _VOLUMEECBLOBDELETERESPONSE._serialized_end=4688
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_start=4690
  _VOLUMEECSHARDSTOVOLUMEREQUEST._serialized_end=4760
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_start=4762
  _VOLUMEECSHARDSTOVOLUMERESPONSE._serialized_end=4794
  _MEMSTATUS._serialized_start=4796
  _MEMSTATUS._serialized_end=4911
  _DISKSTATUS._serialized_start=4914
  _DISKSTATUS._serialized_end=5043
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_start=5046
  _VOLUMETIERMOVEDATTOREMOTEREQUEST._serialized_end=5182
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_start=5184
  _VOLUMETIERMOVEDATTOREMOTERESPONSE._serialized_end=5268
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_start=5270
  _VOLUMETIERMOVEDATFROMREMOTEREQUEST._serialized_end=5375
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_start=5377
  _VOLUMETIERMOVEDATFROMREMOTERESPONSE._serialized_end=5463
  _VOLUMESERVERSTATUSREQUEST._serialized_start=5465
  _VOLUMESERVERSTATUSREQUEST._serialized_end=5492
  _VOLUMESERVERSTATUSRESPONSE._serialized_start=5495
  _VOLUMESERVERSTATUSRESPONSE._serialized_end=5680
  _VOLUMESERVERLEAVEREQUEST._serialized_start=5682
  _VOLUMESERVERLEAVEREQUEST._serialized_end=5708
  _VOLUMESERVERLEAVERESPONSE._serialized_start=5710
  _VOLUMESERVERLEAVERESPONSE._serialized_end=5737
  _READNEEDLEMETAREQUEST._serialized_start=5739
  _READNEEDLEMETAREQUEST._serialized_end=5830
  _READNEEDLEMETARESPONSE._serialized_start=5832
  _READNEEDLEMETARESPONSE._serialized_end=5943
  _FETCHANDWRITENEEDLEREQUEST._serialized_start=5946
  _FETCHANDWRITENEEDLEREQUEST._serialized_end=6310
  _FETCHANDWRITENEEDLEREQUEST_REPLICA._serialized_start=6249
  _FETCHANDWRITENEEDLEREQUEST_REPLICA._serialized_end=6310
  _FETCHANDWRITENEEDLERESPONSE._serialized_start=6312
  _FETCHANDWRITENEEDLERESPONSE._serialized_end=6356
  _QUERYREQUEST._serialized_start=6359
  _QUERYREQUEST._serialized_end=7504
  _QUERYREQUEST_FILTER._serialized_start=6635
  _QUERYREQUEST_FILTER._serialized_end=6690
  _QUERYREQUEST_INPUTSERIALIZATION._serialized_start=6693
  _QUERYREQUEST_INPUTSERIALIZATION._serialized_end=7130
  _QUERYREQUEST_INPUTSERIALIZATION_CSVINPUT._serialized_start=6902
  _QUERYREQUEST_INPUTSERIALIZATION_CSVINPUT._serialized_end=7103
  _QUERYREQUEST_INPUTSERIALIZATION_JSONINPUT._serialized_start=7105
  _QUERYREQUEST_INPUTSERIALIZATION_JSONINPUT._serialized_end=7130
  _QUERYREQUEST_OUTPUTSERIALIZATION._serialized_start=7133
  _QUERYREQUEST_OUTPUTSERIALIZATION._serialized_end=7504
  _QUERYREQUEST_OUTPUTSERIALIZATION_CSVOUTPUT._serialized_start=7323
  _QUERYREQUEST_OUTPUTSERIALIZATION_CSVOUTPUT._serialized_end=7464
  _QUERYREQUEST_OUTPUTSERIALIZATION_JSONOUTPUT._serialized_start=7466
  _QUERYREQUEST_OUTPUTSERIALIZATION_JSONOUTPUT._serialized_end=7504
  _QUERIEDSTRIPE._serialized_start=7506
  _QUERIEDSTRIPE._serialized_end=7538
  _VOLUMENEEDLESTATUSREQUEST._serialized_start=7540
  _VOLUMENEEDLESTATUSREQUEST._serialized_end=7605
  _VOLUMENEEDLESTATUSRESPONSE._serialized_start=7607
  _VOLUMENEEDLESTATUSRESPONSE._serialized_end=7733
  _PINGREQUEST._serialized_start=7735
  _PINGREQUEST._serialized_end=7785
  _PINGRESPONSE._serialized_start=7787
  _PINGRESPONSE._serialized_end=7870
  _VOLUMESERVER._serialized_start=7873
  _VOLUMESERVER._serialized_end=12541
# @@protoc_insertion_point(module_scope)
